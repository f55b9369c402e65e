# ported from paddle_tpu/ops/math_ops.py
"""Core math ops of the training slice.

Fluid equivalents: ``operators/mul_op.cc``, ``matmul_op.cc``,
``elementwise/*``, ``scale_op.cc``, ``sum_op.cc``, ``mean_op.cc``,
``sign_op.cc``, ``cast_op.cc``, ``clip_op.cc``, ``clip_by_norm_op.cc``,
``squared_l2_norm_op.cc``, ``increment_op.cc``. Each is a few torch calls;
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
    x, y = _promoted(x, y)
    out = torch.tensordot(x, y, dims=(list(range(xd, x.dim())),
                                      list(range(yd))))
    ctx.set_output("Out", out)


def _promoted(x, y):
    """x and y in their common dtype, as ``jnp.dot_general`` / ``jnp.matmul``
    promote mixed operands (a float32 activation under AMP's bfloat16
    weights gives a float32 product); torch's products refuse them."""
    if x.dtype == y.dtype:
        return x, y
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


@register_op("matmul")
def matmul_op(ctx: OpContext):
    """Batched matmul (reference: operators/matmul_op.cc): the last two
    dims of X and Y, swapped by ``transpose_X`` / ``transpose_Y``, leading
    dims broadcast; the product times ``alpha``, rounded to the product's
    dtype first as the JAX package rounds it."""
    x, y = ctx.input("X"), ctx.input("Y")
    if ctx.attr("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(*_promoted(x, y))
    alpha = float(ctx.attr("alpha", 1.0))
    if alpha != 1.0:
        # a Python scalar: no host-to-device copy
        out = out * float(torch.tensor(alpha, dtype=out.dtype))
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


@register_op("elementwise_max")
def elementwise_max(ctx):
    _elementwise(ctx, torch.maximum)


@register_op("elementwise_min")
def elementwise_min(ctx):
    _elementwise(ctx, torch.minimum)


@register_op("elementwise_pow")
def elementwise_pow(ctx):
    _elementwise(ctx, torch.pow)


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


@register_op("sum")
def sum_op(ctx: OpContext):
    """add_n over the inputs (reference: operators/sum_op.cc), in input
    order. The result is a new tensor bound to ``Out``, so ``Out`` may name
    one of the inputs, as the weight-decay ops write ``grad`` back."""
    xs = ctx.inputs("X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.set_output("Out", out)


@register_op("mean")
def mean_op(ctx: OpContext):
    ctx.set_output("Out", torch.mean(ctx.input("X")))


@register_op("sign")
def sign_op(ctx: OpContext):
    ctx.set_output("Out", torch.sign(ctx.input("X")))


@register_op("cast")
def cast_op(ctx: OpContext):
    x = ctx.input("X")
    ctx.set_output("Out", x.to(to_torch_dtype(ctx.attr("out_dtype", "float32"))))


@register_op("increment")
def increment_op(ctx: OpContext):
    """X + step in X's dtype: an integer counter adds ``int(step)`` (an
    int64 tensor plus a Python float would promote to float32)."""
    x = ctx.input("X")
    step = ctx.attr("step", 1.0)
    ctx.set_output("Out", x + (step if x.is_floating_point() else int(step)))


@register_op("clip")
def clip_op(ctx: OpContext):
    """``jnp.clip``: min(max(x, min), max), the bounds filled on x's device
    (no host-to-device copy)."""
    x = ctx.input("X")
    ctx.set_output("Out", torch.minimum(
        torch.maximum(x, x.new_full((), ctx.attr("min"))),
        x.new_full((), ctx.attr("max"))))


@register_op("clip_by_norm")
def clip_by_norm_op(ctx: OpContext):
    """x·max_norm/‖x‖ where ‖x‖ > max_norm, else x. The norm and the choice
    stay on the device (``torch.where``), so the step captures."""
    x = ctx.input("X")
    max_norm = ctx.attr("max_norm")
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12), 1.0)
    ctx.set_output("Out", x * scale.to(x.dtype))


@register_op("squared_l2_norm")
def squared_l2_norm_op(ctx: OpContext):
    """sum(x²) as a 0-d tensor, the JAX package's shape: the global-norm
    clip's ``sum`` -> ``sqrt`` -> ``elementwise_max`` with a [1] constant
    then broadcasts to [1] as it does there."""
    ctx.set_output("Out", torch.sum(torch.square(ctx.input("X"))))
