# ported from paddle_tpu/ops/tensor_ops.py
"""Tensor manipulation, fill, and random ops of the training slices.

Fluid equivalents live across ``operators/reshape_op.cc``,
``fill_constant_op.cc``, ``uniform_random_op.cc``, ``dropout_op.cc`` etc.

Randomness: the JAX package derives one threefry key per op
(``TraceContext.op_rng``); torch cannot redraw threefry, so here each
stochastic op draws from its own ``torch.Generator`` on the run's device
(:meth:`OpContext.rng`), seeded from (seed attr or ``program.random_seed``,
step index, op position). The draws are deterministic for a seed but are
not the JAX package's bits: parity with it holds at dropout 0, and with
dropout on the tests check the keep rate and the ``is_test`` identity.
Initial weights are carried across as arrays (``paddle_tpu_torch.io``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dtypes import to_torch_dtype
from ..core.registry import OpContext, register_op


def _resolve_shape(shape, x=None):
    """Resolve a Fluid shape attr (may contain -1 and 0) against input x."""
    shape = list(shape)
    if x is not None:
        for i, s in enumerate(shape):
            if s == 0 and i < x.dim():  # 0 means "copy from input" in fluid reshape
                shape[i] = x.shape[i]
    return shape


def _set_xshape(ctx: OpContext, x):
    if ctx.has_output("XShape"):
        ctx.set_output("XShape", x.new_zeros((0,) + tuple(x.shape)))


@register_op("reshape", "reshape2")
def reshape_op(ctx: OpContext):
    x = ctx.input("X")
    shape_tensor = ctx.input("Shape") if ctx.has_input("Shape") else None
    if shape_tensor is not None:
        shape = [int(s) for s in shape_tensor.tolist()]
    else:
        shape = _resolve_shape(ctx.attr("shape"), x)
    ctx.set_output("Out", x.reshape(shape))
    _set_xshape(ctx, x)


@register_op("unsqueeze", "unsqueeze2")
def unsqueeze_op(ctx: OpContext):
    x = ctx.input("X")
    out = x
    for a in sorted(ctx.attr("axes")):
        out = out.unsqueeze(a)
    ctx.set_output("Out", out)
    _set_xshape(ctx, x)


@register_op("transpose", "transpose2")
def transpose_op(ctx: OpContext):
    x = ctx.input("X")
    ctx.set_output("Out", x.permute(*ctx.attr("axis")))
    _set_xshape(ctx, x)


@register_op("split")
def split_op(ctx: OpContext):
    x = ctx.input("X")
    axis = ctx.attr("axis", 0)
    num = ctx.attr("num", 0)
    sections = ctx.attr("sections", [])
    if sections:
        outs = torch.split(x, list(sections), dim=axis)
    else:
        if x.shape[axis] % num:
            raise ValueError("split: dim %d of size %d does not divide into "
                             "%d equal parts" % (axis, x.shape[axis], num))
        outs = torch.split(x, x.shape[axis] // num, dim=axis)
    ctx.set_outputs("Out", outs)


@register_op("concat")
def concat_op(ctx: OpContext):
    ctx.set_output("Out", torch.cat(ctx.inputs("X"), dim=ctx.attr("axis", 0)))


# -- fill / init ops ----------------------------------------------------------


@register_op("fill_constant")
def fill_constant_op(ctx: OpContext):
    dtype = to_torch_dtype(ctx.attr("dtype", "float32"))
    ctx.set_output("Out", torch.full(list(ctx.attr("shape", [])),
                                     ctx.attr("value", 0.0), dtype=dtype,
                                     device=ctx.device))


@register_op("fill_zeros_like")
def fill_zeros_like_op(ctx: OpContext):
    ctx.set_output("Out", torch.zeros_like(ctx.input("X")))


@register_op("assign_value")
def assign_value_op(ctx: OpContext):
    dtype = to_torch_dtype(ctx.attr("dtype", "float32"))
    # the values list is a constant of the program (the Transformer's
    # position table holds seq*d_model floats): convert and copy it to the
    # device once per (device, dtype), not on every step. Ops never write
    # their inputs in place, so the cached tensor is shared safely.
    cache = ctx.op.__dict__.setdefault("_assign_value_cache", {})
    key = (ctx.device, dtype, id(ctx.attr("values")))
    out = cache.get(key)
    if out is None:
        values = torch.as_tensor(np.asarray(ctx.attr("values")))
        out = values.to(device=ctx.device, dtype=dtype).reshape(
            ctx.attr("shape"))
        cache[key] = out
    ctx.set_output("Out", out)


# -- random ops ---------------------------------------------------------------


@register_op("uniform_random")
def uniform_random_op(ctx: OpContext):
    shape = list(ctx.attr("shape"))
    dtype = to_torch_dtype(ctx.attr("dtype", "float32"))
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    u = torch.rand(shape, generator=ctx.rng(), dtype=torch.float32,
                   device=ctx.device)
    ctx.set_output("Out", (u * (hi - lo) + lo).to(dtype))


@register_op("gaussian_random")
def gaussian_random_op(ctx: OpContext):
    shape = list(ctx.attr("shape"))
    dtype = to_torch_dtype(ctx.attr("dtype", "float32"))
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    z = torch.randn(shape, generator=ctx.rng(), dtype=torch.float32,
                    device=ctx.device)
    ctx.set_output("Out", (mean + std * z).to(dtype))


# erf(±2/√2): the normal CDF at ±2 standard deviations, mapped to [-1, 1]
_ERF_2 = math.erf(2.0 / math.sqrt(2.0))


@register_op("truncated_gaussian_random")
def truncated_gaussian_random_op(ctx: OpContext):
    """mean + std·z with z standard normal truncated to [-2, 2], as the JAX
    package draws it (``jax.random.truncated_normal(key, -2, 2)``), by the
    inverse CDF: u uniform in (erf(-√2), erf(√2)), z = √2·erfinv(u). The
    draw happens in place on the run's device from the op's generator, so
    a [5e7, 10] table never passes through the host or a second buffer."""
    shape = list(ctx.attr("shape"))
    dtype = to_torch_dtype(ctx.attr("dtype", "float32"))
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    z = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    z.uniform_(-_ERF_2, _ERF_2, generator=ctx.rng())
    z.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    ctx.set_output("Out", z.mul_(std).add_(mean).to(dtype))


def keep_mask(shape, p, generator, device):
    """Bool mask, True with probability ``1 - p``: the residual dropout
    keeps for the backward is this 1-byte mask, not an x.dtype one."""
    return torch.rand(shape, generator=generator, device=device) >= p


@register_op("dropout")
def dropout_op(ctx: OpContext):
    """Reference: operators/dropout_op.cc. Two impl modes:
    downgrade_in_infer (default): train out = x*mask, infer out = x*(1-p);
    upscale_in_train: train out = x*mask/(1-p), infer out = x.
    """
    x = ctx.input("X")
    p = ctx.attr("dropout_prob", 0.5)
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.is_test:
        if impl == "upscale_in_train":
            ctx.set_output("Out", x)
        else:
            ctx.set_output("Out", x * (1.0 - p))
        return
    if p == 0.0:
        ctx.set_output("Out", x)
        if ctx.has_output("Mask"):
            ctx.set_output("Mask", torch.ones_like(x))
        return
    keep = keep_mask(x.shape, p, ctx.rng(), x.device)
    if impl == "upscale_in_train":
        out = torch.where(keep, x * (1.0 / (1.0 - p)), 0.0)
    else:
        out = torch.where(keep, x, 0.0)
    ctx.set_output("Out", out)
    if ctx.has_output("Mask"):
        ctx.set_output("Mask", keep.to(x.dtype))
