# ported from paddle_tpu/layers/control_flow.py
"""Control-flow layers: of the JAX package's module only ``equal``, which
the unfused attention's segment-id lowering reads
(:func:`.attention._segment_bias`). ``While``, ``cond``, the RNNs and the
other comparisons are not ported yet (ROADMAP Queue 1 item 8)."""

from __future__ import annotations

from .layer_helper import LayerHelper

__all__ = ["equal"]


def _cmp_layer(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(op_type, inputs={"X": x, "Y": y}, outputs={"Out": cond})
    return cond


def equal(x, y, cond=None):
    return _cmp_layer("equal", x, y, cond)
