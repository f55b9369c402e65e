# ported from paddle_tpu/ops/attention_ops.py
"""Attention math of the serving and training paths.

* :func:`neg_inf_value` — the one masking constant every
  attention implementation here shares (composed :func:`sdpa`,
  :func:`decode_attention`, :func:`verify_attention` and the paged-attention
  CUDA kernel), so masking cannot drift between them.
* :func:`sdpa` — the scaled dot-product attention that prefill and the
  ``scaled_dot_product_attention`` op run. From
  ``FLAGS_flash_attention_min_seq`` up it goes through the flash-attention
  kernels (:mod:`.kernels.flash_attention`, K1a-c): without dropout with
  any bias and segment ids, with attention-probs dropout when there is
  neither (the kernels then draw the mask themselves). Below the flag, and
  for what the kernels do not take, it is composed from ``torch.einsum``
  and materialises the [B, H, Sq, Sk] scores. The route depends on shapes,
  dtypes and the flag, never on the device, so a CPU run walks the same
  route through the kernels' plain versions. Both routes compute
  ``softmax(q·kᵀ·sm_scale + bias)·v``. A float32 bias under bfloat16
  q, k, v is read as float32 on both: the composed route then returns
  float32 (the scores promote), the flash route q's dtype, as in the JAX
  package.
* :func:`decode_attention` / :func:`verify_attention` — single-position
  and verify-window attention over a gathered KV context: the plain path
  the paged kernel is held against.
"""

from __future__ import annotations

import torch

from ..core.registry import OpContext, register_op
from ..flags import flags
from .kernels import flash_attention as fa
from .tensor_ops import keep_mask

__all__ = ["neg_inf_value", "paged_kernel_enabled", "sdpa",
           "decode_attention", "verify_attention"]


def neg_inf_value(dtype) -> float:
    """``-0.7 * finfo(dtype).max`` as a Python float: finite in every float
    dtype, while ``exp()`` of it (minus any real score) underflows to
    exactly 0.0, so masked positions contribute exactly nothing. Handed to
    ``torch.where`` as a Python scalar it rounds once to the scores' dtype,
    as the JAX package's ``jnp.asarray(value, dtype)`` rounds it (a CPU
    0-d tensor there would be copied to the card with a host sync)."""
    return -0.7 * float(torch.finfo(dtype).max)


def paged_kernel_enabled() -> bool:
    """Resolve ``FLAGS_paged_attention_kernel``: True = the paged-attention
    wrapper (the CUDA kernel for CUDA tensors, its plain version for CPU
    tensors), False = the page gather + :func:`decode_attention`."""
    mode = str(flags.paged_attention_kernel).lower()
    if mode in ("0", "off", "false", "no"):
        return False
    if mode in ("auto", "1", "on", "true", "yes"):
        return True
    if mode == "interpret":
        raise ValueError(
            "FLAGS_paged_attention_kernel=interpret selects the Pallas "
            "interpreter of the JAX package; the CUDA port has no "
            "interpreter (use auto, on or off)")
    raise ValueError("unknown FLAGS_paged_attention_kernel value %r"
                     % (flags.paged_attention_kernel,))


def _flash_ok(q, k, causal) -> bool:
    """Gate of the flash route: the longer sequence reaches
    ``FLAGS_flash_attention_min_seq``, the kernels are built for the dtype
    and the head width, and a causal mask comes with ``Sq == Sk`` (the
    kernels align it top-left, the composed path bottom-right; the two
    agree only there)."""
    sq, d = q.shape[2], q.shape[3]
    sk = k.shape[2]
    if causal and sq != sk:
        return False
    if max(sq, sk) < int(flags.flash_attention_min_seq):
        return False
    return d in fa.HEAD_DIMS and q.dtype in (torch.float32, torch.bfloat16)


def _draw_seed(gen: torch.Generator) -> torch.Tensor:
    """The seed of the kernels' mask: one int64 drawn from the op's
    generator on the generator's device, as a one-element tensor that the
    kernels read there. Nothing reads it on the host, so a CUDA graph can
    capture the draw (its generator registered with the graph draws anew
    on each replay)."""
    return torch.randint(-2 ** 31, 2 ** 31, (1,), generator=gen,
                         device=gen.device, dtype=torch.int64)


def sdpa(q, k, v, bias=None, segment_ids_q=None, segment_ids_kv=None,
         causal=False, sm_scale=1.0, dropout_rate=0.0, dropout_rng=None):
    """Scaled dot-product attention over [B, H, S, D] tensors. With
    ``dropout_rate`` > 0 and a ``torch.Generator`` as ``dropout_rng``, the
    probabilities are dropped (upscale_in_train): on the flash route by the
    kernels' own mask, seeded from the generator, on the composed route
    through a bool keep mask drawn from it."""
    if _flash_ok(q, k, causal):
        if dropout_rate == 0.0:
            seg = None
            if segment_ids_q is not None:
                seg = fa.SegmentIds(segment_ids_q, segment_ids_kv)
            ab = bias
            if ab is not None:
                # the kernels read a bias of q's dtype or a float32 one (as
                # the Pallas kernels read theirs: in its own dtype, added
                # in float32)
                if ab.dtype != q.dtype:
                    ab = ab.float()
                ab = ab.expand(q.shape[0], q.shape[1], q.shape[2], k.shape[2])
            return fa.flash_attention(q, k, v, ab, seg, causal=causal,
                                      sm_scale=sm_scale)
        if (dropout_rng is not None and bias is None
                and segment_ids_q is None and segment_ids_kv is None):
            return fa.flash_attention(
                q, k, v, causal=causal, sm_scale=sm_scale,
                dropout_rate=dropout_rate,
                dropout_seed=_draw_seed(dropout_rng))
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    if bias is not None:
        scores = scores + bias
    ninf = neg_inf_value(scores.dtype)
    if segment_ids_q is not None:
        mask = (segment_ids_q[:, None, :, None]
                == segment_ids_kv[:, None, None, :])
        scores = torch.where(mask, scores, ninf)
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        cm = torch.ones((sq, sk), dtype=torch.bool,
                        device=scores.device).tril(diagonal=sk - sq)
        scores = torch.where(cm, scores, ninf)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0 and dropout_rng is not None:
        keep = keep_mask(probs.shape, dropout_rate, dropout_rng, probs.device)
        probs = torch.where(keep, probs * (1.0 / (1.0 - dropout_rate)), 0.0)
    # a float32 bias under bfloat16 q, k promotes the scores, the softmax
    # and the output to float32, as jnp's promotion does in the JAX package
    dt = torch.promote_types(probs.dtype, v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(dt), v.to(dt))


def decode_attention(q, ctx_k, ctx_v, ctx_len, sm_scale=1.0):
    """Single-position attention for autoregressive decode over a gathered
    KV context.

    ``q`` [B,H,D] is the current position's query per batch slot; ``ctx_k``/
    ``ctx_v`` [B,L,H,D] is the slot's cache context (a paged gather or a
    contiguous cache slice). ``ctx_len`` [B] counts the valid leading
    positions, INCLUDING the current token, whose k/v the caller wrote
    before calling. Invalid positions are masked with
    :func:`neg_inf_value`, so cache garbage beyond ``ctx_len`` contributes
    exactly nothing. Returns [B,H,D].
    """
    scores = torch.einsum("bhd,blhd->bhl", q, ctx_k) * sm_scale
    pos = torch.arange(ctx_k.shape[1], device=q.device)
    mask = pos[None, None, :] < ctx_len[:, None, None]
    scores = torch.where(mask, scores, neg_inf_value(scores.dtype))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhl,blhd->bhd", probs, ctx_v)


def verify_attention(q, ctx_k, ctx_v, ctx_len, sm_scale=1.0):
    """Verify-window attention: ``q`` [B,W,H,D], window position ``j`` is
    logical position ``ctx_len[b] - 1 + j`` and sees ``ctx_len + j``
    positions, so causality inside the window falls out of per-row ragged
    masking. Row 0 with W=1 is :func:`decode_attention`. Returns
    [B,W,H,D]."""
    w = q.shape[1]
    lens = ctx_len[:, None] + torch.arange(w, device=q.device)[None, :]
    scores = torch.einsum("bwhd,blhd->bwhl", q, ctx_k) * sm_scale
    pos = torch.arange(ctx_k.shape[1], device=q.device)
    mask = pos[None, None, None, :] < lens[:, :, None, None]
    scores = torch.where(mask, scores, neg_inf_value(scores.dtype))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bwhl,blhd->bwhd", probs, ctx_v)


@register_op("scaled_dot_product_attention")
def sdpa_op(ctx: OpContext):
    q, k, v = ctx.input("Q"), ctx.input("K"), ctx.input("V")
    bias = ctx.input("Bias")
    seg_q = ctx.input("SegmentIdsQ")
    seg_kv = ctx.input("SegmentIdsKV")
    causal = ctx.attr("causal", False)
    sm_scale = ctx.attr("sm_scale", 1.0)
    p = 0.0 if ctx.is_test else ctx.attr("dropout_rate", 0.0)
    rng = ctx.rng() if p > 0.0 else None
    ctx.set_output("Out", sdpa(q, k, v, bias, seg_q, seg_kv, causal, sm_scale,
                               p, rng))
