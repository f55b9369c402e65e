# ported from paddle_tpu/layers/tensor.py
"""Tensor-construction layers (reference: python/paddle/fluid/layers/tensor.py)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import unique_name
from ..core.framework import Variable
from .layer_helper import LayerHelper

__all__ = [
    "create_tensor",
    "create_parameter",
    "create_global_var",
    "cast",
    "concat",
    "sums",
    "assign",
    "fill_constant",
    "fill_constant_batch_size_like",
    "ones",
    "zeros",
    "ones_like",
    "zeros_like",
    "reshape",
    "transpose",
    "reverse",
    "scale",
    "increment",
    "cumsum",
    "range",
    "linspace",
    "has_inf",
    "has_nan",
    "isfinite",
    "sum",
]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_global_variable(shape=(), dtype=dtype, name=name, persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False, default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    from .layer_helper import ParamAttr

    attr = ParamAttr.to_attr(attr)
    if name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias, default_initializer)


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    from .. import initializer as init_mod

    helper = LayerHelper("global_var", name=name)
    name = name or unique_name.generate("global_var")
    var = helper.create_or_get_global_variable(
        list(shape), dtype, name, persistable=persistable,
        initializer=init_mod.Constant(float(value)))
    return var


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": x}, outputs={"Out": out},
                     attrs={"out_dtype": dtype, "in_dtype": x.dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", inputs={"X": list(input)}, outputs={"Out": out}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sums")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("sum", inputs={"X": list(input)}, outputs={"Out": out})
    return out


def sum(x):
    helper = LayerHelper("sum")
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    helper.append_op("sum", inputs={"X": list(xs)}, outputs={"Out": out})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("assign", inputs={"X": input}, outputs={"Out": output})
    else:
        value = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(value.dtype.name)
        helper.append_op(
            "assign_value",
            outputs={"Out": output},
            attrs={"shape": list(value.shape), "dtype": value.dtype.name,
                   "values": value.reshape(-1).tolist()},
        )
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("fill_constant", outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": dtype, "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value, input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("fill_constant_batch_size_like", inputs={"Input": input}, outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": dtype, "value": float(value),
                            "input_dim_idx": input_dim_idx, "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones_like(x, out=None):
    helper = LayerHelper("ones_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_zeros_like", inputs={"X": x}, outputs={"Out": out})
    helper.append_op("increment", inputs={"X": out}, outputs={"Out": out}, attrs={"step": 1.0})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_zeros_like", inputs={"X": x}, outputs={"Out": out})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op("reshape2", inputs={"X": x}, outputs={"Out": out, "XShape": xshape},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op("transpose2", inputs={"X": x}, outputs={"Out": out, "XShape": xshape},
                     attrs={"axis": list(perm)})
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(x.dtype)
    axis = axis if isinstance(axis, (list, tuple)) else [axis]
    helper.append_op("reverse", inputs={"X": x}, outputs={"Out": out}, attrs={"axis": list(axis)})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": x}, outputs={"Out": out},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("increment", inputs={"X": x}, outputs={"Out": out}, attrs={"step": float(value)})
    return out


def cumsum(x, axis=None, exclusive=None, reverse=None):
    helper = LayerHelper("cumsum")
    out = helper.create_variable_for_type_inference(x.dtype)
    attrs = {}
    if axis is not None:
        attrs["axis"] = axis
    if exclusive is not None:
        attrs["exclusive"] = exclusive
    if reverse is not None:
        attrs["reverse"] = reverse
    helper.append_op("cumsum", inputs={"X": x}, outputs={"Out": out}, attrs=attrs)
    return out


def range(start, end, step, dtype):
    helper = LayerHelper("range")
    start = fill_constant([1], dtype, start) if not isinstance(start, Variable) else start
    end = fill_constant([1], dtype, end) if not isinstance(end, Variable) else end
    step = fill_constant([1], dtype, step) if not isinstance(step, Variable) else step
    out = helper.create_variable_for_type_inference(start.dtype)
    helper.append_op("range", inputs={"Start": start, "End": end, "Step": step}, outputs={"Out": out})
    return out


def linspace(start, stop, num, dtype):
    helper = LayerHelper("linspace")
    start = fill_constant([1], dtype, start) if not isinstance(start, Variable) else start
    stop = fill_constant([1], dtype, stop) if not isinstance(stop, Variable) else stop
    num = fill_constant([1], "int32", num) if not isinstance(num, Variable) else num
    out = helper.create_variable_for_type_inference(start.dtype)
    helper.append_op("linspace", inputs={"Start": start, "Stop": stop, "Num": num}, outputs={"Out": out})
    return out


def isfinite(x):
    helper = LayerHelper("isfinite")
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op("isfinite", inputs={"X": x}, outputs={"Out": out})
    return out


def has_inf(x):
    helper = LayerHelper("has_inf")
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op("has_inf", inputs={"X": x}, outputs={"Out": out})
    return out


def has_nan(x):
    helper = LayerHelper("has_nan")
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op("has_nan", inputs={"X": x}, outputs={"Out": out})
    return out


def tensor_array_to_tensor(input, axis=1, name=None):
    """Concatenate a TensorArray's entries along ``axis`` (reference:
    layers/tensor.py tensor_array_to_tensor →
    operators/tensor_array_to_tensor_op.cc). Returns (out, out_index) where
    out_index holds each entry's extent along the axis."""
    from .layer_helper import LayerHelper

    helper = LayerHelper("tensor_array_to_tensor", name=name)
    out = helper.create_variable_for_type_inference(
        getattr(input, "elem_dtype", "float32"))
    idx = helper.create_variable_for_type_inference("int32")
    helper.append_op("tensor_array_to_tensor", inputs={"X": input},
                     outputs={"Out": out, "OutIndex": idx},
                     attrs={"axis": int(axis)})
    return out, idx


__all__.append("tensor_array_to_tensor")
