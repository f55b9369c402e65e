# ported from paddle_tpu/ops/quantize_ops.py
"""Fake-quantization ops for QAT (reference: operators/fake_quantize_op.cc —
fake_quantize_abs_max, fake_quantize_range_abs_max,
fake_channel_wise_quantize_abs_max, fake_dequantize_max_abs,
fake_channel_wise_dequantize_max_abs; plus the later
moving_average_abs_max variants).

Quantized values are kept in float storage (int grid, float dtype) like the
reference's simulated-quantization path; ``torch.round`` rounds half to
even, as ``jnp.round`` does. Gradients use the straight-through estimator:
the reference registers an identity grad functor (FakeQuantGradFunctor),
here :class:`_STE`, a ``torch.autograd.Function`` whose forward is the
quantized value and whose backward passes the gradient to its first
input. As in the JAX package, the scale of a quant op's ``OutScale``
output is not detached (a dequant through it differentiates the abs-max);
only the divisor inside the quantizer is.

State (the running scale, the window, the accumulators) flows through the
executor's in-place output convention: an op writes
``OutScale``/``OutScales``/``OutAccum``/``OutState`` under the persistable
var names it read, and the step writes them back into the scope's tensors
(``copy_`` into the static state in a captured step). Every update is a
device op on device tensors: the window's slot is an index tensor, so no
value is read on the host and the ops capture.
"""

from __future__ import annotations

import torch

from ..core.registry import OpContext, register_op


class _STE(torch.autograd.Function):
    """Forward: ``q``; backward: the gradient into ``x`` unchanged
    (reference FakeQuantGradFunctor)."""

    @staticmethod
    def forward(ctx, x, q):
        return q

    @staticmethod
    def backward(ctx, g):
        return g, None


def _ste(x, q):
    return _STE.apply(x, q.detach())


def _qrange(bits: int) -> float:
    return float((1 << (bits - 1)) - 1)


def _over(t, c: float):
    """``t / c`` rounded once on either device: PyTorch's CUDA division by
    a Python scalar multiplies by its reciprocal (two roundings), which
    parted the card from the CPU by an ulp; a tensor divisor is divided."""
    return t / torch.full_like(t, c)


def _quantized(x, scale, r):
    """(STE output on the int grid, x's quantized values) for a scale that
    broadcasts against x; the scale's gradient stops here."""
    safe = torch.clamp(scale, min=1e-8).detach()
    q = torch.round(torch.clamp(x / safe, -1.0, 1.0) * r)
    return _ste(x * (r / safe), q)


def quantize_abs_max(x, bits: int):
    """→ (quantized int-grid values in float, scale)."""
    scale = torch.amax(torch.abs(x))
    return _quantized(x, scale, _qrange(bits)), scale


@register_op("fake_quantize_abs_max")
def fake_quantize_abs_max_op(ctx: OpContext):
    x = ctx.input("X")
    bits = int(ctx.attr("bit_length", 8))
    out, scale = quantize_abs_max(x, bits)
    ctx.set_output("Out", out)
    ctx.set_output("OutScale", scale.reshape(1))


@register_op("fake_channel_wise_quantize_abs_max")
def fake_channel_wise_quantize_abs_max_op(ctx: OpContext):
    """Per-output-channel (dim 0) scales — conv/mul weight quantization."""
    x = ctx.input("X")
    bits = int(ctx.attr("bit_length", 8))
    scale = torch.amax(torch.abs(x), dim=tuple(range(1, x.dim())))
    shaped = scale.reshape((-1,) + (1,) * (x.dim() - 1))
    ctx.set_output("Out", _quantized(x, shaped, _qrange(bits)))
    ctx.set_output("OutScale", scale)


@register_op("fake_quantize_range_abs_max")
def fake_quantize_range_abs_max_op(ctx: OpContext):
    """Windowed max scale (reference FakeQuantizeRangeAbsMaxOp): a
    [window_size] buffer of per-step abs-maxes, the step's at slot
    ``Iter % window_size``; OutScale = max(window). Test mode uses the
    frozen InScale."""
    x = ctx.input("X")
    in_scale = ctx.input("InScale")          # [1] persistable
    it = ctx.input("Iter")                   # [1] int64 persistable
    window = ctx.input("OutScales")          # [window_size] persistable
    bits = int(ctx.attr("bit_length", 8))
    window_size = int(ctx.attr("window_size", 10000))

    if ctx.is_test:
        scale = in_scale.reshape(())
    else:
        cur = torch.amax(torch.abs(x))
        pos = it.reshape(1).to(torch.int64) % window_size
        window = window.index_put((pos,), cur.reshape(1).to(window.dtype))
        scale = torch.amax(window)
        ctx.set_output("OutScales", window)
        ctx.set_output("OutScale", scale.reshape(1))
    ctx.set_output("Out", _quantized(x, scale, _qrange(bits)))


def _moving_average_scale(ctx: OpContext, x, rho):
    """The EMA scale accum/state of the moving-average ops, writing their
    OutAccum, OutState and OutScale in training; the frozen InScale in
    test mode."""
    if ctx.is_test:
        return ctx.input("InScale").reshape(())
    in_accum, in_state = ctx.input("InAccum"), ctx.input("InState")
    cur = torch.amax(torch.abs(x))
    accum = (in_accum.reshape(()) if in_accum is not None else 0.0) * rho + cur
    state = (in_state.reshape(()) if in_state is not None
             else torch.zeros_like(cur)) * rho + 1.0
    scale = accum / state
    ctx.set_output("OutAccum", accum.reshape(1))
    ctx.set_output("OutState", state.reshape(1))
    ctx.set_output("OutScale", scale.reshape(1))
    return scale


@register_op("fake_quantize_moving_average_abs_max")
def fake_quantize_moving_average_abs_max_op(ctx: OpContext):
    """EMA scale: state = accum/state counters (reference
    FakeQuantizeMovingAverageAbsMaxOp)."""
    x = ctx.input("X")
    bits = int(ctx.attr("bit_length", 8))
    scale = _moving_average_scale(ctx, x, float(ctx.attr("moving_rate", 0.9)))
    ctx.set_output("Out", _quantized(x, scale, _qrange(bits)))


@register_op("fake_dequantize_max_abs")
def fake_dequantize_max_abs_op(ctx: OpContext):
    """Out = X * Scale / max_range (reference FakeDequantizeMaxAbsOp)."""
    x = ctx.input("X")
    scale = ctx.input("Scale").reshape(())
    max_range = float(ctx.attr("max_range"))
    ctx.set_output("Out", x * _over(scale, max_range))


@register_op("fake_channel_wise_dequantize_max_abs")
def fake_channel_wise_dequantize_max_abs_op(ctx: OpContext):
    x = ctx.input("X")
    scales = ctx.inputs("Scales")
    bits = ctx.attr("quant_bits", [8])
    out = x
    for s, b in zip(scales, bits):
        if s.dim() >= 1 and s.shape[0] == x.shape[0] and s.numel() > 1:
            shp = (-1,) + (1,) * (x.dim() - 1)
            out = out * _over(s.reshape(shp), _qrange(int(b)))
        else:
            out = out * _over(s.reshape(()), _qrange(int(b)))
    ctx.set_output("Out", out)


@register_op("fake_quantize_dequantize_moving_average_abs_max")
def fake_qdq_moving_average_op(ctx: OpContext):
    """Fused quant+dequant (activation QAT in later reference versions);
    its gradient passes to X unchanged."""
    x = ctx.input("X")
    bits = int(ctx.attr("bit_length", 8))
    r = _qrange(bits)
    scale = _moving_average_scale(ctx, x, float(ctx.attr("moving_rate", 0.9)))
    safe = torch.clamp(scale, min=1e-8).detach()
    q = torch.round(torch.clamp(x / safe, -1.0, 1.0) * r) * _over(safe, r)
    ctx.set_output("Out", _ste(x, q))
