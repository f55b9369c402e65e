# ported from paddle_tpu/layers/math_op_patch.py
"""Operator overloading on Variable (reference: layers/math_op_patch.py)."""

from __future__ import annotations

import numpy as np

from ..core.framework import Variable


def binary_op(x: Variable, other, op_name: str, reverse: bool = False) -> Variable:
    from .layer_helper import LayerHelper
    from . import tensor as tensor_layers

    helper = LayerHelper(op_name)
    if not isinstance(other, Variable):
        # scalar fast path for add/sub/mul/div via scale op
        scalar = float(other)
        if not reverse:
            if op_name == "elementwise_add":
                return tensor_layers.scale(x, scale=1.0, bias=scalar)
            if op_name == "elementwise_sub":
                return tensor_layers.scale(x, scale=1.0, bias=-scalar)
            if op_name == "elementwise_mul":
                return tensor_layers.scale(x, scale=scalar)
            if op_name == "elementwise_div":
                return tensor_layers.scale(x, scale=1.0 / scalar)
        else:
            if op_name == "elementwise_add":
                return tensor_layers.scale(x, scale=1.0, bias=scalar)
            if op_name == "elementwise_sub":
                return tensor_layers.scale(x, scale=-1.0, bias=scalar)
            if op_name == "elementwise_mul":
                return tensor_layers.scale(x, scale=scalar)
        other = tensor_layers.fill_constant([1], x.dtype, scalar)
    a, b = (other, x) if reverse else (x, other)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_name, inputs={"X": a, "Y": b}, outputs={"Out": out}, attrs={"axis": -1})
    return out
