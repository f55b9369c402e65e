# ported from paddle_tpu/ops/activation_ops.py
"""Activation ops (reference: ``operators/activation_op.cc:491-510``): the
JAX package's whole table, each one torch expression whose autograd
gradient is the JAX package's.

At a kink JAX's autodiff takes a particular subgradient, and each
expression here is written so that torch's autograd takes the same one:
a clip is ``minimum(maximum(x, lo), hi)`` (half the gradient at either
bound, as ``jnp.clip`` gives; ``torch.clamp`` would give all of it),
``abs`` and ``leaky_relu`` branch on ``x >= 0`` (gradient 1 at 0),
``hard_shrink``, ``soft_shrink`` and ``thresholded_relu`` on strict
comparisons (0 at ±threshold), ``maxout`` splits a tie evenly
(``amax``), and ``round``, ``floor``, ``ceil`` and ``sign`` have a zero
gradient. ``soft_relu`` clips before ``log1p(exp)``, and ``selu`` uses
``jax.nn.selu``'s constants.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import OpContext, register_op

# jax.nn.selu's constants
_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def _clip(x, lo, hi):
    """``jnp.clip``: min(max(x, lo), hi), the bounds 0-d tensors filled on
    x's device (no host-to-device copy)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, x.new_zeros(()))


def _elu(x, alpha):
    """``jax.nn.elu``: x above 0, alpha·expm1(x) at and below it."""
    pos = x > 0
    return torch.where(pos, x, alpha * torch.expm1(torch.where(pos, 0.0, x)))


_SIMPLE = {
    "sigmoid": torch.sigmoid,
    "logsigmoid": lambda x: -_softplus(-x),
    "exp": torch.exp,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "tanh_shrink": lambda x: x - torch.tanh(x),
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "abs": lambda x: torch.where(x >= 0, x, -x),
    "ceil": torch.ceil,
    "floor": torch.floor,
    "cos": torch.cos,
    "sin": torch.sin,
    "round": torch.round,
    "reciprocal": torch.reciprocal,
    "log": torch.log,
    "square": torch.square,
    "softplus": _softplus,
    "softsign": lambda x: x / (torch.where(x >= 0, x, -x) + 1),
    "log1p": torch.log1p,
    "erf": torch.erf,
    "selu": lambda x: _SELU_SCALE * _elu(x, _SELU_ALPHA),
}


def _make_simple(fn):
    def impl(ctx: OpContext):
        ctx.set_output("Out", fn(ctx.input("X")))

    return impl


for _name, _fn in _SIMPLE.items():
    register_op(_name)(_make_simple(_fn))


@register_op("gelu")
def gelu_op(ctx: OpContext):
    # approximate: the tanh form; else the erf form
    approximate = "tanh" if ctx.attr("approximate", False) else "none"
    ctx.set_output("Out", F.gelu(ctx.input("X"), approximate=approximate))


@register_op("leaky_relu")
def leaky_relu_op(ctx: OpContext):
    x = ctx.input("X")
    ctx.set_output("Out", torch.where(x >= 0, x, x * ctx.attr("alpha", 0.02)))


@register_op("relu6")
def relu6_op(ctx: OpContext):
    ctx.set_output("Out", _clip(ctx.input("X"), 0.0,
                                ctx.attr("threshold", 6.0)))


@register_op("pow")
def pow_op(ctx: OpContext):
    ctx.set_output("Out", torch.pow(ctx.input("X"),
                                    float(ctx.attr("factor", 1.0))))


@register_op("stanh")
def stanh_op(ctx: OpContext):
    x = ctx.input("X")
    a, b = ctx.attr("scale_a", 0.67), ctx.attr("scale_b", 1.7159)
    ctx.set_output("Out", b * torch.tanh(a * x))


@register_op("hard_sigmoid")
def hard_sigmoid_op(ctx: OpContext):
    x = ctx.input("X")
    slope, offset = ctx.attr("slope", 0.2), ctx.attr("offset", 0.5)
    ctx.set_output("Out", _clip(slope * x + offset, 0.0, 1.0))


@register_op("swish")
def swish_op(ctx: OpContext):
    x = ctx.input("X")
    ctx.set_output("Out", x * torch.sigmoid(ctx.attr("beta", 1.0) * x))


@register_op("elu")
def elu_op(ctx: OpContext):
    ctx.set_output("Out", _elu(ctx.input("X"), ctx.attr("alpha", 1.0)))


@register_op("brelu")
def brelu_op(ctx: OpContext):
    ctx.set_output("Out", _clip(ctx.input("X"), ctx.attr("t_min", 0.0),
                                ctx.attr("t_max", 24.0)))


@register_op("soft_relu")
def soft_relu_op(ctx: OpContext):
    t = ctx.attr("threshold", 40.0)
    ctx.set_output("Out", torch.log1p(torch.exp(_clip(ctx.input("X"), -t, t))))


@register_op("hard_shrink")
def hard_shrink_op(ctx: OpContext):
    x = ctx.input("X")
    t = ctx.attr("threshold", 0.5)
    ctx.set_output("Out", torch.where(x.abs() > t, x, 0.0))


@register_op("soft_shrink", "softshrink")
def soft_shrink_op(ctx: OpContext):
    x = ctx.input("X")
    lam = ctx.attr("lambda", 0.5)
    ctx.set_output("Out", torch.where(
        x > lam, x - lam, torch.where(x < -lam, x + lam, 0.0)))


@register_op("thresholded_relu")
def thresholded_relu_op(ctx: OpContext):
    x = ctx.input("X")
    ctx.set_output("Out", torch.where(x > ctx.attr("threshold", 1.0), x, 0.0))


@register_op("prelu")
def prelu_op(ctx: OpContext):
    """``mode`` "all": one alpha; "channel": one a channel (axis 1);
    "element": one an element of x's non-batch shape."""
    x, alpha = ctx.input("X"), ctx.input("Alpha")
    mode = ctx.attr("mode", "all")
    if mode == "channel" and alpha.numel() > 1:
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == "all":
        alpha = alpha.reshape(())
    ctx.set_output("Out", torch.where(x >= 0, x, alpha.to(x.dtype) * x))


@register_op("maxout")
def maxout_op(ctx: OpContext):
    """NCHW: the max over each run of ``groups`` channels."""
    x = ctx.input("X")
    groups = ctx.attr("groups")
    n, c, h, w = x.shape
    ctx.set_output("Out", x.reshape(n, c // groups, groups, h, w).amax(2))
