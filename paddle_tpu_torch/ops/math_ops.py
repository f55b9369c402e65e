# ported from paddle_tpu/ops/math_ops.py
"""Core math ops of the training slice.

Fluid equivalents: ``operators/mul_op.cc``, ``matmul_op.cc``,
``elementwise/*``, ``scale_op.cc``, ``sum_op.cc``, ``mean_op.cc``,
``sign_op.cc``, ``cast_op.cc``, ``clip_op.cc``, ``clip_by_norm_op.cc``,
``squared_l2_norm_op.cc``, ``increment_op.cc``, ``cumsum_op.cc``,
``norm_op.cc``, ``l1_norm_op.cc``, ``squared_l2_distance_op.cc``,
``cos_sim_op.cc``, ``minus_op.cc``, ``bilinear_tensor_product_op.cc``,
``isfinite_op.cc``. Each is a few torch calls;
the products go to cuBLAS through ``torch.tensordot`` (the JAX package
leaves them to XLA: no Pallas kernel sits here). ``isfinite``,
``has_inf`` and ``has_nan`` answer with a 0-d bool on the device: nothing
is read on the host.
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
    # ranks only (a lower rank differs in shape already): a comparison of
    # sizes would pin a symbolic batch size under torch.export
    if axis != -1 and y.dim() < x.dim():
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


@register_op("elementwise_mod")
def elementwise_mod(ctx):
    """Python's sign rule (``jnp.mod``): the result takes y's sign."""
    _elementwise(ctx, torch.remainder)


@register_op("elementwise_floordiv")
def elementwise_floordiv(ctx):
    """``jnp.floor_divide``: the quotient rounded toward -inf."""
    _elementwise(ctx, lambda x, y: torch.div(x, y, rounding_mode="floor"))


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


def _abs(x):
    """``jnp.abs`` with its gradient: +1 at 0 (``torch.abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


@register_op("cumsum")
def cumsum_op(ctx: OpContext):
    """The JAX package's formulation: ``reverse`` flips, sums and flips
    back, ``exclusive`` subtracts x from the inclusive sum."""
    x = ctx.input("X")
    axis = ctx.attr("axis", -1)
    rev = ctx.attr("reverse", False)
    if rev:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, axis, dtype=x.dtype)
    if ctx.attr("exclusive", False):
        out = out - x
    if rev:
        out = torch.flip(out, (axis,))
    ctx.set_output("Out", out)


@register_op("norm")
def norm_op(ctx: OpContext):
    x = ctx.input("X")
    norm = torch.sqrt(torch.sum(torch.square(x), ctx.attr("axis", -1),
                                keepdim=True) + ctx.attr("epsilon", 1e-10))
    ctx.set_output("Out", x / norm)
    ctx.set_output("Norm", norm)


@register_op("l1_norm")
def l1_norm_op(ctx):
    ctx.set_output("Out", torch.sum(_abs(ctx.input("X"))))


@register_op("squared_l2_distance")
def squared_l2_distance_op(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    diff = x - y
    ctx.set_output("sub_result", diff)
    ctx.set_output("Out", torch.sum(torch.square(diff),
                                    tuple(range(1, diff.dim())))
                   .reshape(x.shape[0], 1))


@register_op("cos_sim")
def cos_sim_op(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    xn = torch.sqrt(torch.sum(torch.square(x), -1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), -1, keepdim=True))
    ctx.set_output("XNorm", xn)
    ctx.set_output("YNorm", yn)
    ctx.set_output("Out", torch.sum(x * y, -1, keepdim=True) / (xn * yn))


@register_op("minus")
def minus_op(ctx):
    ctx.set_output("Out", ctx.input("X") - ctx.input("Y"))


@register_op("bilinear_tensor_product")
def bilinear_tensor_product_op(ctx: OpContext):
    """out[b, o] = x[b]·W[o]·y[b] (+ bias), W [out, dx, dy]."""
    x, y, w = ctx.input("X"), ctx.input("Y"), ctx.input("Weight")
    out = torch.einsum("bi,oij,bj->bo", x, w, y)
    bias = ctx.input("Bias")
    if bias is not None:
        out = out + bias
    ctx.set_output("Out", out)


@register_op("dot")
def dot_op(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    ctx.set_output("Out", torch.sum(x * y, -1, keepdim=True))


@register_op("isfinite")
def isfinite_op(ctx):
    ctx.set_output("Out", torch.all(torch.isfinite(ctx.input("X"))))


@register_op("has_inf")
def has_inf_op(ctx):
    ctx.set_output("Out", torch.any(torch.isinf(ctx.input("X"))))


@register_op("has_nan")
def has_nan_op(ctx):
    ctx.set_output("Out", torch.any(torch.isnan(ctx.input("X"))))
