# ported from paddle_tpu/ops/reduce_ops.py
"""Reduce ops of the training slice (reference: operators/reduce_ops/).
Only ``reduce_sum`` is ported so far."""

from __future__ import annotations

import torch

from ..core.registry import OpContext, register_op


def _reduce(ctx: OpContext, fn):
    x = ctx.input("X")
    dims = ctx.attr("dim", [0])
    keep_dim = ctx.attr("keep_dim", False)
    if ctx.attr("reduce_all", False):
        ctx.set_output("Out", fn(x))
        return
    axes = tuple(d % x.dim() for d in dims)
    ctx.set_output("Out", fn(x, dim=axes, keepdim=keep_dim))


@register_op("reduce_sum")
def reduce_sum_op(ctx):
    _reduce(ctx, torch.sum)
