# ported from paddle_tpu/imperative/layers.py
"""Dygraph Layer base classes (reference: python/paddle/fluid/imperative/layers.py:28,216).

``Layer`` owns eagerly-initialized parameters (VarBase) and composes via
attribute assignment, mirroring the reference's Layer/sublayer/parameter
registries. ``PyLayer`` wraps a user-defined forward as a
``torch.autograd.Function``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import initializer as init_mod
from ..core import unique_name
from ..core.dtypes import convert_dtype, to_torch_dtype
from ..layers.layer_helper import ParamAttr
from . import tracer as tracer_mod
from .tracer import EagerBlock, VarBase, trace_fn

__all__ = ["Layer", "PyLayer"]


def _zeros(shape, dtype) -> torch.Tensor:
    return torch.zeros(tuple(shape or []), dtype=to_torch_dtype(dtype),
                       device=tracer_mod._device())


class Layer:
    """reference: imperative/layers.py:28 (class Layer(core.Layer))."""

    def __init__(self, name_scope: str, dtype: str = "float32"):
        self._full_name = unique_name.generate(name_scope)
        self._dtype = convert_dtype(dtype)
        self._parameters: Dict[str, VarBase] = {}
        self._sub_layers: Dict[str, "Layer"] = {}
        self._built = False

    def full_name(self) -> str:
        """reference: imperative/layers.py:49."""
        return self._full_name

    # -- parameter/variable creation -----------------------------------------
    def create_parameter(self, attr=None, shape=None, dtype=None, is_bias: bool = False,
                         default_initializer=None) -> VarBase:
        """Eagerly create + initialize a parameter (reference:
        imperative/layers.py:58 → layer_object_helper.py create_parameter).
        The initializer's init op runs immediately through EagerBlock instead
        of being appended to a startup program."""
        attr = ParamAttr.to_attr(attr)
        dtype = convert_dtype(dtype or self._dtype)
        name = attr.name or unique_name.generate(
            "%s.%s" % (self._full_name, "b" if is_bias else "w"))
        initializer = attr.initializer or default_initializer
        if initializer is None:
            initializer = init_mod.Constant(0.0) if is_bias else init_mod.Xavier()
        p = VarBase(_zeros(shape, dtype), name=name, persistable=True,
                    trainable=attr.trainable, is_parameter=True,
                    stop_gradient=not attr.trainable)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        initializer(p, EagerBlock())
        t = tracer_mod.current_tracer()
        if t is not None:
            t.register_parameter(p)
        return p

    def create_variable(self, name: Optional[str] = None, persistable: bool = False,
                        dtype: Optional[str] = None, shape=None) -> VarBase:
        """Non-trainable eager state (e.g. BN running stats); reference:
        imperative/layers.py:79."""
        dtype = convert_dtype(dtype or self._dtype)
        return VarBase(_zeros(shape, dtype),
                       name=name or unique_name.generate("%s.var" % self._full_name),
                       stop_gradient=True, persistable=persistable, trainable=False)

    # -- registries -----------------------------------------------------------
    def parameters(self, include_sublayers: bool = True) -> List[VarBase]:
        ret = list(self._parameters.values())
        if include_sublayers:
            for l in self._sub_layers.values():
                ret.extend(l.parameters(include_sublayers=True))
        return ret

    def sublayers(self, include_sublayers: bool = True) -> List["Layer"]:
        ret = list(self._sub_layers.values())
        if include_sublayers:
            for l in self._sub_layers.values():
                ret.extend(l.sublayers(include_sublayers=True))
        return ret

    def state_dict(self) -> Dict[str, VarBase]:
        """All persistable state by parameter name (for save/load)."""
        out = {p.name: p for p in self.parameters()}
        for l in [self] + self.sublayers():
            for v in vars(l).values():
                if isinstance(v, VarBase) and v.persistable:
                    out[v.name] = v
        return out

    def clear_gradients(self):
        """reference: imperative/layers.py:134."""
        for p in self.parameters():
            p.clear_gradient()

    def set_state(self, state_dict, strict: bool = True):
        """Load arrays produced by ``base.save_dygraph`` (of either
        package) into this Layer's parameters/state by name, in place;
        shapes must match."""
        own = self.state_dict()
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        if strict and (missing or unexpected):
            raise KeyError("state mismatch: missing=%s unexpected=%s"
                           % (missing, unexpected))
        for k, arr in state_dict.items():
            if k not in own:
                continue
            arr = torch.as_tensor(np.asarray(arr))
            if tuple(arr.shape) != own[k].shape:
                raise ValueError(
                    "state %r has shape %s but parameter expects %s"
                    % (k, tuple(arr.shape), own[k].shape))
            own[k].value = arr.to(own[k].value.dtype).to(own[k].value.device)

    # reference-compat alias
    load_dict = set_state

    def train(self):
        t = tracer_mod.current_tracer()
        if t:
            t.train_mode()

    def eval(self):
        t = tracer_mod.current_tracer()
        if t:
            t.eval_mode()

    # -- call protocol --------------------------------------------------------
    def _build_once(self, *args):
        pass

    def __call__(self, *inputs):
        if not self._built:
            self._build_once(*inputs)
            self._built = True
        return self.forward(*inputs)

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *inputs):
        raise ValueError("Layer shouldn't implement backward")

    # -- explicit registration -------------------------------------------------
    def add_sublayer(self, name: str, sublayer: "Layer") -> "Layer":
        assert isinstance(sublayer, Layer)
        self._sub_layers[name] = sublayer
        return sublayer

    def add_parameter(self, name: str, parameter: VarBase) -> VarBase:
        assert isinstance(parameter, VarBase)
        parameter.is_parameter = True
        self._parameters[name] = parameter
        return parameter

    # -- attribute magic (reference: imperative/layers.py:185-214) ------------
    def __getattr__(self, name):
        if "_parameters" in self.__dict__ and name in self.__dict__["_parameters"]:
            return self.__dict__["_parameters"][name]
        if "_sub_layers" in self.__dict__ and name in self.__dict__["_sub_layers"]:
            return self.__dict__["_sub_layers"][name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if isinstance(value, VarBase) and getattr(value, "is_parameter", False):
            # only true parameters — persistable state like BN running stats
            # stays a plain attribute (it must not appear in parameters())
            self.__dict__.get("_parameters", {}).pop(name, None)
            if "_parameters" in self.__dict__:
                self._parameters[name] = value
                return
        elif isinstance(value, Layer):
            if "_sub_layers" in self.__dict__:
                self._sub_layers[name] = value
                return
        object.__setattr__(self, name, value)

    def __delattr__(self, name):
        if name in self.__dict__.get("_parameters", {}):
            del self._parameters[name]
        elif name in self.__dict__.get("_sub_layers", {}):
            del self._sub_layers[name]
        else:
            object.__delattr__(self, name)


class _PyLayerFunction(torch.autograd.Function):
    """A ``PyLayer``'s op: the forward without a tape, and a backward
    that differentiates the forward again on the saved inputs (the JAX
    package replays ``jax.vjp`` of it the same way)."""

    @staticmethod
    def forward(ctx, fwd, *xs):
        ctx.fwd = fwd
        ctx.save_for_backward(*xs)
        return fwd(*xs)

    @staticmethod
    def backward(ctx, *douts):
        xs = [x.detach().requires_grad_(x.is_floating_point())
              for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.fwd(*xs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        leaves = [x for x in xs if x.requires_grad]
        grads = iter(torch.autograd.grad(outs, leaves, douts,
                                         allow_unused=True))
        return (None,) + tuple(next(grads) if x.requires_grad else None
                               for x in xs)


class PyLayer:
    """User-defined eager op (reference: imperative/layers.py:216).

    Subclass with a static ``forward(*tensors)``; the op is a
    ``torch.autograd.Function`` whose backward differentiates that
    forward, as the JAX package takes ``jax.vjp`` of it. A static
    ``backward`` is accepted for API parity and not used, as in the JAX
    package.
    """

    def __init__(self):
        pass

    @staticmethod
    def forward(*inputs):
        raise NotImplementedError

    @staticmethod
    def backward(*douts):
        raise NotImplementedError

    @classmethod
    def __call__(cls, *inputs):
        return cls.apply(*inputs)

    @classmethod
    def apply(cls, *inputs):
        return trace_fn(lambda *xs: _PyLayerFunction.apply(cls.forward, *xs),
                        *inputs)
