# ported from paddle_tpu/ops/math_ops.py
"""Core math ops of the training slice.

Fluid equivalents: ``operators/mul_op.cc``, ``elementwise/*``,
``scale_op.cc``, ``mean_op.cc``, ``cast_op.cc``. Each is a few torch calls;
the products go to cuBLAS through ``torch.tensordot`` (the JAX package
leaves them to XLA: no Pallas kernel sits here).
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
    # AMP autocast: a mixed bf16/f32 binary op computes in the AMP dtype
    # instead of promoting to f32. Without this, one f32 constant entering
    # the residual stream (a positional-encoding table) upcasts every
    # activation after it.
    amp = getattr(getattr(ctx.trace, "program", None), "_amp_dtype", None)
    if amp is not None:

        def castable(slot):
            # Only activations autocast; persistable vars (parameters,
            # master weights, user state) keep their deliberate f32.
            names = ctx.op.inputs.get(slot)
            block = ctx.op.block
            if not names or not block.has_var(names[0]):
                return True
            return not block.var(names[0]).persistable

        adt = to_torch_dtype(amp)
        if x.dtype == adt and y.dtype == torch.float32 and castable("Y"):
            y = y.to(adt)
        elif y.dtype == adt and x.dtype == torch.float32 and castable("X"):
            x = x.to(adt)
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


@register_op("elementwise_sub")
def elementwise_sub(ctx):
    _elementwise(ctx, torch.sub)


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
