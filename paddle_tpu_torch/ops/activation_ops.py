# ported from paddle_tpu/ops/activation_ops.py
"""Activation ops of the training slice (reference:
``operators/activation_op.cc``): ``relu``, the Transformer FFN's
activation, and ``gelu``, the causal LM's."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import OpContext, register_op


@register_op("relu")
def relu_op(ctx: OpContext):
    ctx.set_output("Out", torch.relu(ctx.input("X")))


@register_op("gelu")
def gelu_op(ctx: OpContext):
    # approximate: the tanh form; else the erf form
    approximate = "tanh" if ctx.attr("approximate", False) else "none"
    ctx.set_output("Out", F.gelu(ctx.input("X"), approximate=approximate))
