# ported from paddle_tpu/ops/compare_ops.py
"""Compare and logical ops (reference: operators/controlflow/compare_op.cc,
logical_op.cc). Each is one torch call; Y is cast to X's dtype first, as
the JAX package casts it. The learning-rate schedules read
``less_than`` / ``greater_than`` on the step counter, the unfused
attention's segment-id lowering reads ``equal``."""

from __future__ import annotations

import torch

from ..core.registry import OpContext, register_op

_CMP = {
    "less_than": torch.lt,
    "less_equal": torch.le,
    "greater_than": torch.gt,
    "greater_equal": torch.ge,
    "equal": torch.eq,
    "not_equal": torch.ne,
}


def _make_cmp(fn):
    def impl(ctx: OpContext):
        x, y = ctx.input("X"), ctx.input("Y")
        if x.dtype != y.dtype:
            y = y.to(x.dtype)
        ctx.set_output("Out", fn(x, y))

    return impl


for _name, _fn in _CMP.items():
    register_op(_name)(_make_cmp(_fn))


@register_op("logical_and")
def logical_and_op(ctx: OpContext):
    ctx.set_output("Out", torch.logical_and(ctx.input("X"), ctx.input("Y")))


@register_op("logical_or")
def logical_or_op(ctx: OpContext):
    ctx.set_output("Out", torch.logical_or(ctx.input("X"), ctx.input("Y")))


@register_op("logical_xor")
def logical_xor_op(ctx: OpContext):
    ctx.set_output("Out", torch.logical_xor(ctx.input("X"), ctx.input("Y")))


@register_op("logical_not")
def logical_not_op(ctx: OpContext):
    ctx.set_output("Out", torch.logical_not(ctx.input("X")))
