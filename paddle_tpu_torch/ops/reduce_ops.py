# ported from paddle_tpu/ops/reduce_ops.py
"""Reduce ops (reference: operators/reduce_ops/ — reduce_sum, mean, max,
min, prod, all, any, and logsumexp).

``reduce_max`` / ``reduce_min`` are ``torch.amax`` / ``amin``: their
gradient splits evenly among tied extremes, as ``jnp.max``'s does
(``torch.max(dim)`` would give it all to one index). ``torch.prod`` takes
one dim, so several are moved to the end and flattened into one first.
"""

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


def _prod(x, dim=None, keepdim=False):
    if dim is None:
        return torch.prod(x)
    dims = sorted(set(dim))
    rest = [d for d in range(x.dim()) if d not in dims]
    out = torch.prod(x.permute(rest + dims).reshape(
        [x.shape[d] for d in rest] + [-1]), -1)
    if keepdim:
        out = out.reshape([1 if d in dims else x.shape[d]
                           for d in range(x.dim())])
    return out


def _logsumexp(x, dim=None, keepdim=False):
    return torch.logsumexp(x, tuple(range(x.dim())) if dim is None else dim,
                           keepdim=keepdim)


@register_op("reduce_sum")
def reduce_sum_op(ctx):
    _reduce(ctx, torch.sum)


@register_op("reduce_mean")
def reduce_mean_op(ctx):
    _reduce(ctx, torch.mean)


@register_op("reduce_max")
def reduce_max_op(ctx):
    _reduce(ctx, torch.amax)


@register_op("reduce_min")
def reduce_min_op(ctx):
    _reduce(ctx, torch.amin)


@register_op("reduce_prod")
def reduce_prod_op(ctx):
    _reduce(ctx, _prod)


@register_op("reduce_all")
def reduce_all_op(ctx):
    _reduce(ctx, torch.all)


@register_op("reduce_any")
def reduce_any_op(ctx):
    _reduce(ctx, torch.any)


@register_op("logsumexp")
def logsumexp_op(ctx):
    _reduce(ctx, _logsumexp)
