# ported from paddle_tpu/imperative/nn.py
"""Dygraph layers (reference: python/paddle/fluid/imperative/nn.py —
Conv2D:28, Pool2D:134, FC:193, BatchNorm:266, Embedding:388).

Each forward dispatches the same registered ops the static graph uses
(tracer.dispatch), so numerics match static mode exactly. BatchNorm's
running statistics are state variables, not parameters, written in place
each training forward (the static op's MeanOut/VarianceOut in-place
outputs), so a captured step updates the tensors it captured.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import initializer as init_mod
from .layers import Layer
from .tracer import VarBase, assign_state, dispatch

__all__ = ["Conv2D", "Pool2D", "FC", "BatchNorm", "Embedding"]


def _act(out: VarBase, act: Optional[str]) -> VarBase:
    if act is None:
        return out
    return dispatch(act, {"X": out})


def _pair(v):
    return [v, v] if isinstance(v, int) else list(v)


class Conv2D(Layer):
    """reference: imperative/nn.py:28."""

    def __init__(self, name_scope, num_channels, num_filters, filter_size,
                 stride=1, padding=0, dilation=1, groups=None, param_attr=None,
                 bias_attr=None, use_cudnn=False, act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        groups = groups or 1
        filter_size = _pair(filter_size)
        self._stride = _pair(stride)
        self._padding = _pair(padding)
        self._dilation = _pair(dilation)
        self._groups = groups
        self._act = act
        filter_shape = [num_filters, num_channels // groups] + filter_size
        std = (2.0 / (filter_shape[1] * filter_shape[2] * filter_shape[3])) ** 0.5
        self.weight = self.create_parameter(
            attr=param_attr, shape=filter_shape, dtype=dtype,
            default_initializer=init_mod.Normal(0.0, std))
        self.bias = (None if bias_attr is False else self.create_parameter(
            attr=bias_attr, shape=[num_filters], dtype=dtype, is_bias=True))

    def forward(self, input):
        out = dispatch("conv2d", {"Input": input, "Filter": self.weight},
                       attrs={"strides": self._stride, "paddings": self._padding,
                              "dilations": self._dilation, "groups": self._groups},
                       out_slots=("Output",))
        if self.bias is not None:
            out = dispatch("elementwise_add", {"X": out, "Y": self.bias},
                           attrs={"axis": 1})
        return _act(out, self._act)


class Pool2D(Layer):
    """reference: imperative/nn.py:134."""

    def __init__(self, name_scope, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, use_cudnn=False,
                 ceil_mode=False, exclusive=True, dtype="float32"):
        super().__init__(name_scope, dtype)
        if pool_type not in ("max", "avg"):
            raise ValueError("pool_type must be 'max' or 'avg', got %r" % pool_type)
        self._attrs = {
            "pooling_type": pool_type,
            "ksize": _pair(pool_size),
            "strides": _pair(pool_stride),
            "paddings": _pair(pool_padding),
            "global_pooling": global_pooling,
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
        }

    def forward(self, input):
        return dispatch("pool2d", {"X": input}, attrs=dict(self._attrs))


class FC(Layer):
    """reference: imperative/nn.py:193 — lazily sized on first input."""

    def __init__(self, name_scope, size, param_attr=None, bias_attr=None,
                 num_flatten_dims=1, dtype="float32", act=None):
        super().__init__(name_scope, dtype)
        self._size = size
        self._num_flatten_dims = num_flatten_dims
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._act = act

    def _build_once(self, input):
        in_dim = 1
        for d in input.shape[self._num_flatten_dims:]:
            in_dim *= int(d)
        self.weight = self.create_parameter(
            attr=self._param_attr, shape=[in_dim, self._size], dtype=self._dtype)
        self.bias = (None if self._bias_attr is False else self.create_parameter(
            attr=self._bias_attr, shape=[self._size], dtype=self._dtype, is_bias=True))

    def forward(self, input):
        out = dispatch("mul", {"X": input, "Y": self.weight},
                       attrs={"x_num_col_dims": self._num_flatten_dims,
                              "y_num_col_dims": 1})
        if self.bias is not None:
            out = dispatch("elementwise_add", {"X": out, "Y": self.bias},
                           attrs={"axis": out.value.dim() - 1})
        return _act(out, self._act)


class BatchNorm(Layer):
    """reference: imperative/nn.py:266. Running stats are eager state vars
    updated in place each training forward."""

    def __init__(self, name_scope, num_channels, act=None, is_test=False,
                 momentum=0.9, epsilon=1e-5, param_attr=None, bias_attr=None,
                 dtype="float32", data_layout="NCHW", use_global_stats=False,
                 moving_mean_name=None, moving_variance_name=None):
        super().__init__(name_scope, dtype)
        self._momentum = momentum
        self._epsilon = epsilon
        self._act = act
        self._is_test = is_test
        self._layout = data_layout
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            attr=param_attr, shape=[num_channels], dtype=dtype,
            default_initializer=init_mod.Constant(1.0))
        self.bias = self.create_parameter(
            attr=bias_attr, shape=[num_channels], dtype=dtype, is_bias=True)
        self._mean = self.create_variable(
            name=moving_mean_name, persistable=True, dtype=dtype, shape=[num_channels])
        self._variance = self.create_variable(
            name=moving_variance_name, persistable=True, dtype=dtype, shape=[num_channels])
        with torch.no_grad():
            self._variance.value.fill_(1.0)

    def forward(self, input):
        from . import tracer as tracer_mod

        t = tracer_mod.current_tracer()
        # constructor is_test=True pins inference; otherwise follow the
        # tracer's train/eval mode (Layer.eval()) like the static trace does
        is_test = True if self._is_test else (t is not None and not t.training)
        y, mean_out, var_out = dispatch(
            "batch_norm",
            {"X": input, "Scale": self.weight, "Bias": self.bias,
             "Mean": self._mean, "Variance": self._variance},
            attrs={"momentum": self._momentum, "epsilon": self._epsilon,
                   "data_layout": self._layout, "is_test": is_test,
                   "use_global_stats": self._use_global_stats},
            out_slots=("Y", "MeanOut", "VarianceOut"))
        if not is_test:
            assign_state(self._mean, mean_out.value)
            assign_state(self._variance, var_out.value)
        return _act(y, self._act)


class Embedding(Layer):
    """reference: imperative/nn.py:388."""

    def __init__(self, name_scope, size, is_sparse=False, is_distributed=False,
                 padding_idx=None, param_attr=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._size = size
        # normalize to a non-negative row index (the op impl only masks >= 0)
        self._padding_idx = (-1 if padding_idx is None
                             else padding_idx if padding_idx >= 0
                             else size[0] + padding_idx)
        self.weight = self.create_parameter(
            attr=param_attr, shape=list(size), dtype=dtype,
            default_initializer=init_mod.Xavier())
        if padding_idx is not None:
            with torch.no_grad():
                self.weight.value[self._padding_idx] = 0.0

    def forward(self, input):
        return dispatch("lookup_table_v2", {"W": self.weight, "Ids": input},
                        attrs={"padding_idx": self._padding_idx})
