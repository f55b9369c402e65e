# ported from paddle_tpu/ops/pallas_kernels/flash_attention.py
"""Flash attention: the three CUDA kernels and their plain versions.

Composed attention materialises the [B, H, Sq, Sk] scores, their softmax
and both gradients; at long sequence lengths that is the memory of a
training step. The kernels (``paddle_tpu_torch/csrc/flash_attention.cu``)
walk the scores tile by tile and keep, besides the output, one float32
log-sum-exp per query row:

* K1a (:func:`flash_fwd`): ``o = dropout(softmax(s)) · v`` and ``lse``,
* K1b (:func:`flash_bwd_dkv`): ``dk``, ``dv``, recomputing
  ``p = exp(s − lse)``,
* K1c (:func:`flash_bwd_dq`): ``dq``, and ``ds`` as the bias gradient,

with ``s = q·kᵀ·sm_scale + ab``, masked (by adding −0.7·float32 max) where
the segment ids differ or, with ``causal``, where ``k position > q
position``. The scale comes before the bias, as in the composed ``sdpa`` of
both packages; the JAX package's Pallas kernels add the bias first, so a
caller comparing with them hands them ``ab / sm_scale``.

Dropout drops the normalised probabilities (upscale in train) and leaves
the statistics alone. Its keep mask (:func:`dropout_keep_mask`) is a hash
of (seed, b, h, q position, k position) in wrap-around uint32 arithmetic,
bit for bit the JAX package's ``_dropout_keep_tile``, so the forward and
both backward kernels redraw the same mask from the seed alone.

A query row that sees no position at all (possible only through segment
ids) gets ``o = 0`` and ``lse = +inf``, so ``p = 0`` and no gradient
flows through it. (The composed ``sdpa`` averages ``v`` over such a row.)

:func:`flash_attention` is the autograd-aware entry point
(:class:`FlashAttention`). Each wrapper takes its plain version
(:func:`flash_fwd_reference`, :func:`flash_bwd_dkv_reference`,
:func:`flash_bwd_dq_reference`) for tensors on the CPU; for CUDA tensors it
launches the kernel or raises. Nothing falls back from a kernel to the
plain version. Every launch adds one to :data:`LAUNCHES_FWD`,
:data:`LAUNCHES_DKV` or :data:`LAUNCHES_DQ`.

Layout: q, k, v, do may be any strided view with a unit last stride (the
attention layer hands over transposed ``[B, S, H, D]`` tensors); the
kernels read them in place, and the outputs are allocated with the layout
of the tensor they belong to, so the layer's transpose back is free.

In bfloat16, K1a, K1b and K1c run on the tensor cores (``mma.sync``); in
float32 they are register-blocked FFMA tiles. Every kernel loads its
operands with 16-byte ``cp.async`` copies, and a view whose base or strides
miss 16 bytes goes to it as an aligned copy (:func:`_staged`); the
attention layer's views never do.

The bias ``ab`` has q's dtype, or float32 under bfloat16 q, k, v: the
kernels read it in its own dtype and add it in float32, as the Pallas
kernels do, and K1c returns ``dab`` in the bias's dtype.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

__all__ = ["flash_attention", "FlashAttention", "SegmentIds",
           "dropout_keep_mask", "dropout_threshold", "flash_fwd",
           "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd_reference",
           "flash_bwd_dkv_reference", "flash_bwd_dq_reference",
           "MASK_VALUE", "HEAD_DIMS", "bind", "LAUNCHES_FWD",
           "LAUNCHES_DKV", "LAUNCHES_DQ"]

LAUNCHES_FWD = 0  # K1a launches since import (or since a caller reset it)
LAUNCHES_DKV = 0  # K1b launches
LAUNCHES_DQ = 0   # K1c launches

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIMS = (32, 64, 128)  # head widths the kernels are built for

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = None


class SegmentIds(NamedTuple):
    """Segment ids of the q and kv sequences: a position attends only to
    positions with its own id."""

    q: torch.Tensor   # [B, Sq] integers
    kv: torch.Tensor  # [B, Sk] integers


_Strides = ctypes.c_longlong * 3  # {batch, head, row}, in elements


class _Params(ctypes.Structure):
    """``FlashParams`` of ``csrc/flash_attention.cu``, field for field."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("q", "k", "v", "ab", "seg_q", "seg_kv", "o", "lse", "dout", "di",
          "dq", "dk", "dv", "dab")]
        + [(n + "_st", _Strides) for n in
           ("q", "k", "v", "ab", "o", "do", "dq", "dk", "dv")]
        + [(n, ctypes.c_int) for n in
           ("b", "h", "sq", "sk", "d", "causal", "dtype", "ab_dtype",
            "dropout")]
        + [("seed", ctypes.c_uint), ("threshold", ctypes.c_uint),
           ("keep_scale", ctypes.c_float), ("sm_scale", ctypes.c_float)])


def bind(lib):
    """The three entry points (K1a, K1b, K1c) of a loaded build of
    ``csrc/flash_attention.cu``, typed for ctypes."""
    fns = (lib.flash_attention_fwd, lib.flash_attention_bwd_dkv,
           lib.flash_attention_bwd_dq)
    for fn in fns:
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def _kernels():
    global _fns
    if _fns is None:
        from . import _build

        _fns = bind(_build.load("flash_attention"))
    return _fns


# -- dropout mask -------------------------------------------------------------

_U32 = 0xFFFFFFFF


def dropout_threshold(rate: float) -> int:
    """The uint32 threshold of ``rate``: an element is kept where its hash
    is ``>=`` it."""
    return min(int(float(rate) * 4294967296.0), 4294967295)


def dropout_keep_mask(rate, seed, b_idx, h_idx, q_offset, k_offset, shape,
                      device=None):
    """Bool keep mask of a ``shape = (rows, cols)`` tile whose first element
    is query position ``q_offset`` and key position ``k_offset`` of batch
    row ``b_idx`` and head ``h_idx``. ``b_idx`` and ``h_idx`` may be
    tensors that broadcast against the tile (``[B,1,1,1]``, ``[1,H,1,1]``).
    uint32 arithmetic written in int64 masked to 32 bits: an int64 product
    may wrap, which leaves its low 32 bits right."""
    rows = torch.arange(shape[0], dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(shape[1], dtype=torch.int64, device=device)[None, :]
    rows = (rows + int(q_offset)) & _U32
    cols = (cols + int(k_offset)) & _U32
    x = ((rows * 2654435761) & _U32) ^ ((cols * 0x85EBCA6B) & _U32)
    x = x ^ (((int(seed) & _U32) + b_idx * 0x9E3779B9 + h_idx * 0xC2B2AE35)
             & _U32)
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _U32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _U32
    x = x ^ (x >> 16)
    return x >= dropout_threshold(rate)


def _full_keep_mask(rate, seed, b, h, sq, sk, device):
    bi = torch.arange(b, dtype=torch.int64, device=device)[:, None, None, None]
    hi = torch.arange(h, dtype=torch.int64, device=device)[None, :, None, None]
    return dropout_keep_mask(rate, seed, bi, hi, 0, 0, (sq, sk), device)


# -- plain versions -----------------------------------------------------------


def _compute_dtype(q):
    """float32 for the kernels' input types; float64 stays float64, so the
    plain path can be gradient-checked."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _scores(q, k, ab, segment_ids, causal, sm_scale):
    """The masked scores ``s`` [B,H,Sq,Sk] in the compute dtype."""
    ct = _compute_dtype(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)) * sm_scale
    if ab is not None:
        s = s + ab.to(ct)
    mask = None
    if segment_ids is not None:
        mask = (segment_ids.q[:, None, :, None]
                == segment_ids.kv[:, None, None, :])
    if causal:
        sq, sk = s.shape[-2:]
        cm = (torch.arange(sk, device=s.device)[None, :]
              <= torch.arange(sq, device=s.device)[:, None])
        mask = cm if mask is None else mask & cm
    if mask is not None:
        s = s + torch.where(mask, 0.0, MASK_VALUE).to(ct)
    return s


def _dropped(x, rate, seed):
    """``x`` [B,H,Sq,Sk] through the dropout of (rate, seed)."""
    if not rate:
        return x
    b, h, sq, sk = x.shape
    keep = _full_keep_mask(rate, seed, b, h, sq, sk, x.device)
    return torch.where(keep, x * (1.0 / (1.0 - rate)), 0.0)


def flash_fwd_reference(q, k, v, ab=None, segment_ids=None, causal=False,
                        sm_scale=1.0, dropout_rate=0.0, dropout_seed=0):
    """The plain version of K1a: ``(o, lse)``, o in q's dtype, lse
    [B,H,Sq] float32 (float64 for float64 inputs)."""
    ct = _compute_dtype(q)
    s = _scores(q, k, ab, segment_ids, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    dead = m < 0.5 * MASK_VALUE  # every position masked
    lse = torch.where(dead, float("inf"), m + torch.log(l)).squeeze(-1)
    # the operand of p·v has the inputs' type, as in the kernel
    pd = _dropped(e, dropout_rate, dropout_seed).to(q.dtype).to(ct)
    o = torch.einsum("bhqk,bhkd->bhqd", pd, v.to(ct))
    o = torch.where(dead, 0.0, o / l)
    return o.to(q.dtype), lse


def _p_and_ds(q, k, v, ab, segment_ids, lse, do, di, causal, sm_scale,
              dropout_rate, dropout_seed):
    """``(dropout(p), ds)`` [B,H,Sq,Sk] in the compute dtype, with
    ``p = exp(s − lse)`` and ``ds = p·(dropout'(do·vᵀ) − di)``."""
    ct = _compute_dtype(q)
    s = _scores(q, k, ab, segment_ids, causal, sm_scale)
    p = torch.exp(s - lse.to(ct)[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(ct), v.to(ct))
    dp = _dropped(dp, dropout_rate, dropout_seed)
    ds = p * (dp - di.to(ct)[..., None])
    return _dropped(p, dropout_rate, dropout_seed), ds


def flash_bwd_dkv_reference(q, k, v, ab, segment_ids, lse, do, di,
                            causal=False, sm_scale=1.0, dropout_rate=0.0,
                            dropout_seed=0):
    """The plain version of K1b: ``(dk, dv)`` in k's and v's dtype."""
    ct = _compute_dtype(q)
    pd, ds = _p_and_ds(q, k, v, ab, segment_ids, lse, do, di, causal,
                       sm_scale, dropout_rate, dropout_seed)
    dv = torch.einsum("bhqk,bhqd->bhkd", pd.to(q.dtype).to(ct), do.to(ct))
    dk = torch.einsum("bhqk,bhqd->bhkd",
                      (ds * sm_scale).to(q.dtype).to(ct), q.to(ct))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, ab, segment_ids, lse, do, di,
                           causal=False, sm_scale=1.0, dropout_rate=0.0,
                           dropout_seed=0):
    """The plain version of K1c: ``(dq, dab)``; ``dab`` is ``ds`` in the
    bias's dtype, None without a bias."""
    ct = _compute_dtype(q)
    _, ds = _p_and_ds(q, k, v, ab, segment_ids, lse, do, di, causal,
                      sm_scale, dropout_rate, dropout_seed)
    dq = torch.einsum("bhqk,bhkd->bhqd",
                      (ds * sm_scale).to(q.dtype).to(ct), k.to(ct))
    return dq.to(q.dtype), None if ab is None else ds.to(ab.dtype)


# -- the wrappers -------------------------------------------------------------


def _check(q, k, v, ab, segment_ids, dropout_rate):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B,H,S,D], got shapes %s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (b, h, sk, d) or tuple(v.shape) != (b, h, sk, d):
        raise ValueError("k and v must be [%d,%d,Sk,%d], got shapes %s %s"
                         % (b, h, d, tuple(k.shape), tuple(v.shape)))
    if min(b, h, sq, sk) < 1:
        raise ValueError("empty attention: q %s k %s"
                         % (tuple(q.shape), tuple(k.shape)))
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k, v dtypes differ: %s %s %s"
                        % (q.dtype, k.dtype, v.dtype))
    tensors = [("k", k), ("v", v)]
    if ab is not None:
        if tuple(ab.shape) != (b, h, sq, sk):
            raise ValueError("ab must be [%d,%d,%d,%d], got shape %s"
                             % (b, h, sq, sk, tuple(ab.shape)))
        if ab.dtype != q.dtype and not (q.dtype == torch.bfloat16
                                        and ab.dtype == torch.float32):
            raise TypeError("ab must have q's dtype %s (or float32 under "
                            "bfloat16), got %s" % (q.dtype, ab.dtype))
        tensors.append(("ab", ab))
    if segment_ids is not None:
        if tuple(segment_ids.q.shape) != (b, sq) \
                or tuple(segment_ids.kv.shape) != (b, sk):
            raise ValueError(
                "segment ids must be [%d,%d] and [%d,%d], got shapes %s %s"
                % (b, sq, b, sk, tuple(segment_ids.q.shape),
                   tuple(segment_ids.kv.shape)))
        tensors += [("segment_ids.q", segment_ids.q),
                    ("segment_ids.kv", segment_ids.kv)]
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError("q on %s, %s on %s" % (q.device, name, t.device))
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError("dropout_rate must be in [0, 1), got %r"
                         % (dropout_rate,))
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError("flash attention runs on cuda or cpu, got %s"
                         % q.device)


def _check_cuda(q, named):
    """What the kernels need beyond :func:`_check`."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError("the flash kernels take %s, got %s"
                        % (sorted(map(str, _DTYPE_CODE)), q.dtype))
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError("the flash kernels are built for head widths %s, "
                         "got %d" % (HEAD_DIMS, q.shape[3]))
    if q.shape[0] > 65535 or q.shape[1] > 65535:
        raise ValueError("batch %d and heads %d must each be <= 65535"
                         % (q.shape[0], q.shape[1]))
    for name, t in named:
        if t is not None and t.stride(-1) != 1:
            raise ValueError("%s must have a unit last stride, got strides %s"
                             % (name, t.stride()))


def _cp_async_ok(t):
    """Whether the kernels, which load by 16-byte ``cp.async`` copies (K1a-c
    in both dtypes), can copy ``t`` in place: its base address and its
    batch, head and row strides (those of dimensions with more than one
    index) are whole multiples of 16 bytes, that is of 8 bfloat16 or 4
    float32 elements. A contiguous tensor, the ``[B,S,H,D]``
    transpose and a head slice of a fused qkv projection pass; a view
    offset by one element does not."""
    per16 = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or s % per16 == 0 for n, s in zip(t.shape[:3], t.stride()[:3]))


def _staged(t):
    """``t`` where :func:`_cp_async_ok`, else a fresh contiguous copy of it,
    which the allocator aligns. The copy runs on the card and feeds the
    same kernel: it is no path to the plain version."""
    if _cp_async_ok(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _like(t):
    """An empty tensor of t's shape and dtype, laid out [B,S,H,D] under a
    transposed view when t is, else contiguous."""
    b, h, s, d = t.shape
    if t.stride(2) > t.stride(1):
        return t.new_empty((b, s, h, d)).transpose(1, 2)
    return t.new_empty((b, h, s, d))


def _seg32(segment_ids):
    if segment_ids is None:
        return None, None
    return (segment_ids.q.to(torch.int32).contiguous(),
            segment_ids.kv.to(torch.int32).contiguous())


def _launch(which, q, k, v, ab, seg, causal, sm_scale, dropout_rate,
            dropout_seed, **tensors):
    """Fill ``FlashParams`` and launch kernel ``which`` (0 K1a, 1 K1b,
    2 K1c) on q's device and the current stream; ``tensors`` are the
    kernel's further inputs and outputs by field name."""
    p = _Params()
    b, h, sq, d = q.shape
    seg_q, seg_kv = seg
    fields = dict(q=q, k=k, v=v, ab=ab, seg_q=seg_q, seg_kv=seg_kv,
                  **tensors)
    for name, t in fields.items():
        setattr(p, name, None if t is None else t.data_ptr())
    for name, t in (("q", q), ("k", k), ("v", v), ("ab", ab),
                    ("o", tensors.get("o")), ("do", tensors.get("dout")),
                    ("dq", tensors.get("dq")), ("dk", tensors.get("dk")),
                    ("dv", tensors.get("dv"))):
        if t is not None:
            setattr(p, name + "_st", _Strides(*t.stride()[:3]))
    p.b, p.h, p.sq, p.sk, p.d = b, h, sq, k.shape[2], d
    p.causal = int(bool(causal))
    p.dtype = _DTYPE_CODE[q.dtype]
    p.ab_dtype = p.dtype if ab is None else _DTYPE_CODE[ab.dtype]
    p.dropout = int(dropout_rate > 0.0)
    p.seed = int(dropout_seed or 0) & _U32
    p.threshold = dropout_threshold(dropout_rate)
    p.keep_scale = 1.0 / (1.0 - dropout_rate)
    p.sm_scale = float(sm_scale)
    fn = _kernels()[which]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(ctypes.byref(p), stream)
    if err != 0:
        raise RuntimeError("flash attention kernel %s launch failed: "
                           "cudaError_t %d"
                           % (("fwd", "bwd_dkv", "bwd_dq")[which], err))


def flash_fwd(q, k, v, ab=None, segment_ids=None, causal=False,
              sm_scale=1.0, dropout_rate=0.0, dropout_seed=0):
    """``(o, lse)``: K1a on CUDA tensors, the plain version on CPU
    tensors."""
    global LAUNCHES_FWD
    _check(q, k, v, ab, segment_ids, dropout_rate)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, ab, segment_ids, causal,
                                   sm_scale, dropout_rate, dropout_seed)
    _check_cuda(q, (("q", q), ("k", k), ("v", v), ("ab", ab)))
    o = _like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    q, k, v = _staged(q), _staged(k), _staged(v)
    _launch(0, q, k, v, ab, _seg32(segment_ids), causal, sm_scale,
            dropout_rate, dropout_seed, o=o, lse=lse)
    LAUNCHES_FWD += 1
    return o, lse


def _bwd_args(q, k, v, ab, segment_ids, lse, do, di, dropout_rate):
    _check(q, k, v, ab, segment_ids, dropout_rate)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("do must be %s %s, got %s %s"
                         % (tuple(q.shape), q.dtype, tuple(do.shape),
                            do.dtype))
    for name, t in (("lse", lse), ("di", di)):
        if tuple(t.shape) != tuple(q.shape[:3]):
            raise ValueError("%s must be %s, got shape %s"
                             % (name, tuple(q.shape[:3]), tuple(t.shape)))
    for name, t in (("do", do), ("lse", lse), ("di", di)):
        if t.device != q.device:
            raise ValueError("q on %s, %s on %s" % (q.device, name, t.device))


def flash_bwd_dkv(q, k, v, ab, segment_ids, lse, do, di, causal=False,
                  sm_scale=1.0, dropout_rate=0.0, dropout_seed=0):
    """``(dk, dv)`` from the forward's ``lse``, the output gradient ``do``
    and ``di = rowsum(o·do)``: K1b on CUDA tensors, the plain version on
    CPU tensors."""
    global LAUNCHES_DKV
    _bwd_args(q, k, v, ab, segment_ids, lse, do, di, dropout_rate)
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, ab, segment_ids, lse, do, di,
                                       causal, sm_scale, dropout_rate,
                                       dropout_seed)
    _check_cuda(q, (("q", q), ("k", k), ("v", v), ("ab", ab), ("do", do)))
    dk, dv = _like(k), _like(v)
    q, k, v, do = _staged(q), _staged(k), _staged(v), _staged(do)
    _launch(1, q, k, v, ab, _seg32(segment_ids), causal, sm_scale,
            dropout_rate, dropout_seed, lse=lse.float().contiguous(),
            dout=do, di=di.float().contiguous(), dk=dk, dv=dv)
    LAUNCHES_DKV += 1
    return dk, dv


def flash_bwd_dq(q, k, v, ab, segment_ids, lse, do, di, causal=False,
                 sm_scale=1.0, dropout_rate=0.0, dropout_seed=0,
                 need_dab=True):
    """``(dq, dab)``; ``dab`` [B,H,Sq,Sk] is written only when there is a
    bias and ``need_dab`` (else None): K1c on CUDA tensors, the plain
    version on CPU tensors."""
    global LAUNCHES_DQ
    _bwd_args(q, k, v, ab, segment_ids, lse, do, di, dropout_rate)
    if q.device.type == "cpu":
        dq, dab = flash_bwd_dq_reference(q, k, v, ab, segment_ids, lse, do,
                                         di, causal, sm_scale, dropout_rate,
                                         dropout_seed)
        return dq, dab if need_dab else None
    _check_cuda(q, (("q", q), ("k", k), ("v", v), ("ab", ab), ("do", do)))
    dq = _like(q)
    dab = None if ab is None or not need_dab else torch.empty(
        ab.shape, dtype=ab.dtype, device=ab.device)
    q, k, v, do = _staged(q), _staged(k), _staged(v), _staged(do)
    _launch(2, q, k, v, ab, _seg32(segment_ids), causal, sm_scale,
            dropout_rate, dropout_seed, lse=lse.float().contiguous(),
            dout=do, di=di.float().contiguous(), dq=dq, dab=dab)
    LAUNCHES_DQ += 1
    return dq, dab


class FlashAttention(torch.autograd.Function):
    """``o`` [B,H,Sq,D]; the forward is K1a, the backward K1b and K1c (or
    their plain versions). Saves q, k, v, the bias, ``o`` and ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, ab, seg_q, seg_kv, causal, sm_scale,
                dropout_rate, dropout_seed):
        seg = None if seg_q is None else SegmentIds(seg_q, seg_kv)
        o, lse = flash_fwd(q, k, v, ab, seg, causal, sm_scale, dropout_rate,
                           dropout_seed)
        ctx.save_for_backward(q, k, v, ab, seg_q, seg_kv, o, lse)
        ctx.args = (causal, sm_scale, dropout_rate, dropout_seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, ab, seg_q, seg_kv, o, lse = ctx.saved_tensors
        seg = None if seg_q is None else SegmentIds(seg_q, seg_kv)
        ct = _compute_dtype(q)
        di = (o.to(ct) * do.to(ct)).sum(dim=-1)
        if do.stride(-1) != 1:
            do = do.contiguous()
        dk, dv = flash_bwd_dkv(q, k, v, ab, seg, lse, do, di, *ctx.args)
        # a bias that needs no gradient (a padding mask) costs no
        # [B,H,Sq,Sk] write
        dq, dab = flash_bwd_dq(q, k, v, ab, seg, lse, do, di, *ctx.args,
                               need_dab=ctx.needs_input_grad[3])
        return dq, dk, dv, dab, None, None, None, None, None, None


def flash_attention(q, k, v, ab=None, segment_ids: Optional[SegmentIds] = None,
                    *, causal=False, sm_scale=1.0, dropout_rate=0.0,
                    dropout_seed=None):
    """Attention over ``[B, H, S, D]`` tensors through the flash kernels,
    differentiable in q, k, v and the bias ``ab`` [B,H,Sq,Sk] (an expanded
    view will do). ``dropout_seed`` is an integer (its low 32 bits count)
    and is needed for ``dropout_rate`` > 0. On the ``meta`` device of shape
    inference it returns an empty output."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate %r needs a dropout_seed"
                         % (dropout_rate,))
    seg_q, seg_kv = (None, None) if segment_ids is None else segment_ids
    return FlashAttention.apply(q, k, v, ab, seg_q, seg_kv, bool(causal),
                                float(sm_scale), float(dropout_rate),
                                int(dropout_seed or 0))
