# ported from paddle_tpu/clip.py
"""Gradient clipping (reference: python/paddle/fluid/clip.py).

GradientClipByValue (clip.py:120), GradientClipByNorm (:166),
GradientClipByGlobalNorm (:212) — appended as ops on the grad vars after the
backward marker, before optimize ops, exactly like Fluid's
append_gradient_clip_ops (clip.py:336).
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = [
    "ErrorClipByValue",
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "set_gradient_clip",
    "append_gradient_clip_ops",
    "error_clip_callback",
]


class BaseErrorClipAttr:
    pass


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


def error_clip_callback(*args, **kwargs):
    pass


class BaseGradientClipAttr:
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _create_operators(self, param, grad):
        grad.block.append_op("clip", inputs={"X": grad}, outputs={"Out": grad},
                             attrs={"min": self.min, "max": self.max})
        return param, grad


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _create_operators(self, param, grad):
        grad.block.append_op("clip_by_norm", inputs={"X": grad}, outputs={"Out": grad},
                             attrs={"max_norm": self.clip_norm})
        return param, grad


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Global-norm clip: scale = clip_norm / max(global_norm, clip_norm)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        elif context[self.group_name + "_clip_value"] != self.clip_norm:
            raise ValueError("All parameters' clip_norm in a group should be equal")
        from .layers.layer_helper import LayerHelper

        helper = LayerHelper("global_norm")
        sq = helper.create_variable_for_type_inference(grad.dtype)
        grad.block.append_op("squared_l2_norm", inputs={"X": grad}, outputs={"Out": sq})
        context[self.group_name].append((param, grad, sq))

    def _create_operators(self, param, grad):
        # handled at group level in append_gradient_clip_ops
        return param, grad


def set_gradient_clip(clip, param_list=None, program=None):
    from .core.framework import default_main_program

    program = program or default_main_program()
    if param_list is None:
        param_list = program.all_parameters()
    param_list = [program.global_block.var(p) if isinstance(p, str) else p for p in param_list]
    for param in param_list:
        param.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads: List[Tuple]) -> List[Tuple]:
    """reference: clip.py:336."""
    context = {}
    clips = []
    for p, g in param_grads:
        if g is None:
            continue
        clip_attr = getattr(p, "gradient_clip_attr", None) or NullGradientClipAttr()
        clip_attr._process_context(context, p, g)
        clips.append((p, g, clip_attr))

    res = []
    handled_groups = set()
    for p, g, clip_attr in clips:
        if isinstance(clip_attr, GradientClipByGlobalNorm):
            if clip_attr.group_name not in handled_groups:
                _append_global_norm_clip(context, clip_attr.group_name)
                handled_groups.add(clip_attr.group_name)
            res.append((p, g))
        else:
            res.append(clip_attr._create_operators(p, g))
    return res


def _append_global_norm_clip(context, group_name):
    from .layers.layer_helper import LayerHelper

    helper = LayerHelper("global_norm_clip")
    group = context[group_name]
    clip_value = context[group_name + "_clip_value"]
    block = group[0][1].block
    gsum = helper.create_variable_for_type_inference("float32")
    block.append_op("sum", inputs={"X": [sq for _, _, sq in group]}, outputs={"Out": gsum})
    gnorm = helper.create_variable_for_type_inference("float32")
    block.append_op("sqrt", inputs={"X": gsum}, outputs={"Out": gnorm})
    clip_const = helper.create_variable_for_type_inference("float32")
    block.append_op("fill_constant", outputs={"Out": clip_const},
                    attrs={"shape": [1], "dtype": "float32", "value": clip_value})
    denom = helper.create_variable_for_type_inference("float32")
    block.append_op("elementwise_max", inputs={"X": gnorm, "Y": clip_const}, outputs={"Out": denom})
    scale_var = helper.create_variable_for_type_inference("float32")
    block.append_op("elementwise_div", inputs={"X": clip_const, "Y": denom}, outputs={"Out": scale_var})
    for p, g, _ in group:
        block.append_op("elementwise_mul", inputs={"X": g, "Y": scale_var}, outputs={"Out": g})
