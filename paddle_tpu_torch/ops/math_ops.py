# ported from paddle_tpu/ops/math_ops.py
"""Core math ops of the training slice.

Fluid equivalents: ``operators/mul_op.cc``, ``elementwise/*``,
``scale_op.cc``, ``mean_op.cc``, ``cast_op.cc``. Each is a few torch calls;
the products go to cuBLAS through ``torch.tensordot`` (the JAX package
leaves them to XLA: no Pallas kernel sits here). The AMP autocast rule of
the JAX ``_elementwise`` is not ported (no AMP yet).
"""

from __future__ import annotations

import torch

from ..core.dtypes import to_torch_dtype
from ..core.registry import OpContext, register_op


@register_op("mul")
def mul_op(ctx: OpContext):
    """Flattened matmul (reference: operators/mul_op.cc). FC's engine: x's
    dims from ``x_num_col_dims`` on contract against y's first
    ``y_num_col_dims`` dims."""
    x, y = ctx.input("X"), ctx.input("Y")
    xd = ctx.attr("x_num_col_dims", 1)
    yd = ctx.attr("y_num_col_dims", 1)
    if tuple(x.shape[xd:]) != tuple(y.shape[:yd]):
        # contraction matches in product, not per-dim (flatten semantics):
        # reshape the weight side
        y = y.reshape(tuple(x.shape[xd:]) + tuple(y.shape[yd:]))
        yd = x.dim() - xd
    out = torch.tensordot(x, y, dims=(list(range(xd, x.dim())),
                                      list(range(yd))))
    ctx.set_output("Out", out)


def _elementwise(ctx: OpContext, fn):
    x, y = ctx.input("X"), ctx.input("Y")
    axis = ctx.attr("axis", -1)
    if x.shape != y.shape and axis != -1 and y.dim() < x.dim():
        # Fluid axis semantics: y's dims align with x's dims starting at axis.
        new_shape = (1,) * axis + tuple(y.shape) \
            + (1,) * (x.dim() - axis - y.dim())
        y = y.reshape(new_shape)
    # axis == -1: trailing alignment, numpy broadcasting covers it
    ctx.set_output("Out", fn(x, y))


@register_op("elementwise_add")
def elementwise_add(ctx):
    _elementwise(ctx, torch.add)


@register_op("elementwise_mul")
def elementwise_mul(ctx):
    _elementwise(ctx, torch.mul)


@register_op("elementwise_div")
def elementwise_div(ctx):
    _elementwise(ctx, torch.div)


@register_op("scale")
def scale_op(ctx: OpContext):
    x = ctx.input("X")
    scale, bias = ctx.attr("scale", 1.0), ctx.attr("bias", 0.0)
    if not x.is_floating_point():
        # the JAX package casts the attrs to x's dtype first
        scale, bias = int(scale), int(bias)
    if ctx.attr("bias_after_scale", True):
        ctx.set_output("Out", x * scale + bias)
    else:
        ctx.set_output("Out", (x + bias) * scale)


@register_op("mean")
def mean_op(ctx: OpContext):
    ctx.set_output("Out", torch.mean(ctx.input("X")))


@register_op("cast")
def cast_op(ctx: OpContext):
    x = ctx.input("X")
    ctx.set_output("Out", x.to(to_torch_dtype(ctx.attr("out_dtype", "float32"))))
