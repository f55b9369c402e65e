# ported from paddle_tpu/ops/activation_ops.py
"""Activation ops of the training slices (reference:
``operators/activation_op.cc``): ``relu``, the Transformer FFN's and
DeepFM's activation, ``gelu``, the causal LM's and BERT's, ``tanh``,
BERT's pooler, and ``square``, DeepFM's second-order term."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import OpContext, register_op


@register_op("relu")
def relu_op(ctx: OpContext):
    ctx.set_output("Out", torch.relu(ctx.input("X")))


@register_op("tanh")
def tanh_op(ctx: OpContext):
    ctx.set_output("Out", torch.tanh(ctx.input("X")))


@register_op("square")
def square_op(ctx: OpContext):
    ctx.set_output("Out", torch.square(ctx.input("X")))


@register_op("gelu")
def gelu_op(ctx: OpContext):
    # approximate: the tanh form; else the erf form
    approximate = "tanh" if ctx.attr("approximate", False) else "none"
    ctx.set_output("Out", F.gelu(ctx.input("X"), approximate=approximate))
