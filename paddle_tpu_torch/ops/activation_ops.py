# ported from paddle_tpu/ops/activation_ops.py
"""Activation ops of the training slice (reference:
``operators/activation_op.cc``). Only ``relu``, the Transformer FFN's
activation, is ported so far."""

from __future__ import annotations

import torch

from ..core.registry import OpContext, register_op


@register_op("relu")
def relu_op(ctx: OpContext):
    ctx.set_output("Out", torch.relu(ctx.input("X")))
