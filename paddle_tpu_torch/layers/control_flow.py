# ported from paddle_tpu/layers/control_flow.py
"""Control-flow layers: of the JAX package's module the comparisons
(``less_than`` ... ``not_equal``), the logical layers (``logical_xor`` is a generated wrapper,
:mod:`.layer_function_generator`) and ``increment``,
which the learning-rate schedules and the unfused attention's segment-id
lowering (:func:`.attention._segment_bias`) read. ``While``, ``cond`` and
the RNNs are not ported yet (ROADMAP Queue 1 item 8)."""

from __future__ import annotations

from . import tensor as tl
from .layer_helper import LayerHelper

__all__ = ["less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal", "logical_and", "logical_or", "logical_not",
           "increment"]


def _cmp_layer(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(op_type, inputs={"X": x, "Y": y}, outputs={"Out": cond})
    return cond


def less_than(x, y, cond=None, force_cpu=None):
    return _cmp_layer("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _cmp_layer("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _cmp_layer("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _cmp_layer("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _cmp_layer("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _cmp_layer("not_equal", x, y, cond)


def logical_and(x, y, out=None):
    return _cmp_layer("logical_and", x, y, out)


def logical_or(x, y, out=None):
    return _cmp_layer("logical_or", x, y, out)


def logical_not(x, out=None):
    helper = LayerHelper("logical_not")
    if out is None:
        out = helper.create_variable_for_type_inference("bool")
    helper.append_op("logical_not", inputs={"X": x}, outputs={"Out": out})
    return out


increment = tl.increment
