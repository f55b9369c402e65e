# ported from paddle_tpu/ops/pallas_kernels/paged_attention.py
"""Ragged paged decode attention: the CUDA kernel and its plain version.

The serving decode loop's hottest inner loop is one decode attention per
layer per step. The plain path gathers every slot's pages into a
``[B, max_ctx, H, D]`` context and reduces it (:func:`gather_reference`);
the kernel (``paddle_tpu_torch/csrc/paged_attention.cu``) reads the live
K/V rows straight from the flat page pool through the page table, so only
``sum_b ctx_len[b] * H * D`` elements per pool move and the gathered
context never exists.

The kernel splits each slot's live rows into chunks of :data:`CHUNK_ROWS`
rows, one block a (chunk, head, slot), and merges the chunks' partial
softmax states in chunk order inside the same launch: the last block of a
(slot, head) to finish does it, told by an arrival counter.
:func:`chunked_reference` is that arithmetic in plain PyTorch, for the
tests; :func:`chunk_plan` is the number of chunk blocks a (slot, head)
gets.

:func:`paged_decode_attention` is the one entry point. It takes the plain
version for tensors on the CPU, and for CUDA tensors it launches the
kernel or raises: nothing falls back from the kernel to the plain version.
Every launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from ..attention_ops import decode_attention, neg_inf_value

__all__ = ["paged_decode_attention", "gather_reference",
           "chunked_reference", "chunk_plan", "LAUNCHES", "MAX_D",
           "CHUNK_ROWS"]

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)
MAX_D = 256   # largest head width the kernel takes
CHUNK_ROWS = 64  # context rows a block walks (chip_smoke.py times others)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
# the arrival counters of each (device, stream): int32 zeros, which every
# launch leaves at zero
_counters = {}


def _kernel():
    global _fn
    if _fn is None:
        from . import _build

        fn = _build.load("paged_attention").paged_decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def chunk_plan(pages_per_slot, page_size, chunk_rows=CHUNK_ROWS):
    """Chunk blocks the kernel launches for each (slot, head): enough for
    the longest context the page table can hold. Blocks of chunks beyond a
    slot's ``ctx_len`` exit at once; a slot with no live row still runs
    its first, which writes 0."""
    if chunk_rows < 1:
        raise ValueError("chunk_rows must be positive, got %r" % chunk_rows)
    return -(-int(pages_per_slot) * int(page_size) // int(chunk_rows))


def _arrival_counters(device, stream, n):
    buf = _counters.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[(device, stream)] = buf
    return buf


def _check(q, k_pages, v_pages, page_table, ctx_len, page_size):
    if q.dim() != 3:
        raise ValueError("q must be [B,H,D], got shape %s" % (tuple(q.shape),))
    b, h, d = q.shape
    for name, pool in (("k_pages", k_pages), ("v_pages", v_pages)):
        if pool.dim() != 3 or tuple(pool.shape[1:]) != (h, d):
            raise ValueError("%s must be [rows,%d,%d], got shape %s"
                             % (name, h, d, tuple(pool.shape)))
    if k_pages.shape[0] != v_pages.shape[0]:
        raise ValueError("k_pages and v_pages hold %d and %d rows"
                         % (k_pages.shape[0], v_pages.shape[0]))
    if page_size < 1 or k_pages.shape[0] % page_size != 0 \
            or k_pages.shape[0] == 0:
        raise ValueError("pool rows %d not a positive multiple of "
                         "page_size %d" % (k_pages.shape[0], page_size))
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or page_table.shape[1] < 1:
        raise ValueError("page_table must be [%d, pages_per_slot], got "
                         "shape %s" % (b, tuple(page_table.shape)))
    if tuple(ctx_len.shape) != (b,):
        raise ValueError("ctx_len must be [%d], got shape %s"
                         % (b, tuple(ctx_len.shape)))
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError("q and both pools must share one dtype of %s, got "
                        "%s, %s, %s" % (sorted(map(str, _DTYPE_CODE)),
                                        q.dtype, k_pages.dtype, v_pages.dtype))
    if page_table.dtype != torch.int32 or ctx_len.dtype != torch.int32:
        raise TypeError("page_table and ctx_len must be int32, got %s, %s"
                        % (page_table.dtype, ctx_len.dtype))
    if d > MAX_D:
        raise ValueError("head width %d exceeds the kernel's %d" % (d, MAX_D))
    devs = {t.device for t in (q, k_pages, v_pages, page_table, ctx_len)}
    if len(devs) != 1:
        raise ValueError("inputs lie on several devices: %s"
                         % sorted(map(str, devs)))
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("ctx_len", ctx_len)):
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)


def paged_decode_attention(q, k_pages, v_pages, page_table, ctx_len, *,
                           page_size, sm_scale=1.0):
    """Fused ragged paged decode attention.

    ``q`` [B,H,D] — the current position's query per slot. ``k_pages``/
    ``v_pages`` [num_pages*page_size, H, D] — ONE layer of the paged KV
    pool. ``page_table`` [B, pages_per_slot] int32 — each slot's ordered
    page ids, clamped to the pool. ``ctx_len`` [B] int32 — valid leading
    positions per slot. float32 or bfloat16, accumulated in float32.
    Returns [B,H,D] in q's dtype; rows at or beyond ``ctx_len`` contribute
    exactly nothing."""
    ps = int(page_size)
    _check(q, k_pages, v_pages, page_table, ctx_len, ps)
    if q.device.type == "cpu":
        return gather_reference(q, k_pages, v_pages, page_table, ctx_len,
                                ps, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError("paged_decode_attention runs on cuda or cpu, got %s"
                         % q.device)
    return _launch(q, k_pages, v_pages, page_table, ctx_len, ps, sm_scale,
                   CHUNK_ROWS)


def _launch(q, k_pages, v_pages, page_table, ctx_len, page_size, sm_scale,
            chunk_rows):
    """The kernel on checked CUDA tensors, ``chunk_rows`` rows a chunk."""
    global LAUNCHES
    b, h, d = q.shape
    ps = int(page_size)
    pps = page_table.shape[1]
    n_chunks = chunk_plan(pps, ps, chunk_rows)
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ws = counters = None
        if n_chunks > 1:  # partials (m, l, acc) of every chunk block
            ws = torch.empty(b * h * n_chunks * (2 + d), dtype=torch.float32,
                             device=q.device)
            counters = _arrival_counters(q.device, stream, b * h)
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), ctx_len.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(),
                 None if counters is None else counters.data_ptr(),
                 b, h, d, pps, k_pages.shape[0] // ps, ps, int(chunk_rows),
                 float(sm_scale), neg_inf_value(torch.float32),
                 _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError("paged_decode_attention kernel launch failed: "
                           "cudaError_t %d" % err)
    LAUNCHES += 1
    return out


def gather_reference(q, k_pages, v_pages, page_table, ctx_len, page_size,
                     sm_scale=1.0):
    """The plain path the kernel replaces: gather each slot's pages into
    logical order (page ids clamped to the pool, as the kernel clamps
    them) and run :func:`~..attention_ops.decode_attention`, which supplies
    the shared masking constant."""
    ps = int(page_size)
    num_pages = k_pages.shape[0] // ps
    pt = page_table.long().clamp(0, num_pages - 1)
    rows = (pt * ps)[:, :, None] + torch.arange(ps, device=pt.device)
    rows = rows.reshape(pt.shape[0], -1)
    return decode_attention(q, k_pages[rows], v_pages[rows], ctx_len,
                            sm_scale=sm_scale)


def chunked_reference(q, k_pages, v_pages, page_table, ctx_len, page_size,
                      sm_scale=1.0, chunk_rows=CHUNK_ROWS):
    """The kernel's arithmetic in plain PyTorch, for the tests: each slot's
    live rows cut into chunks of ``chunk_rows``, each chunk's softmax state
    (m, l, acc) in float32, the states folded one into the next in chunk
    order, and acc / max(l, 1e-30), so a slot with no live row gives 0
    (the gather path averages ``v`` there). Returns [B,H,D] in q's
    dtype."""
    ps = int(page_size)
    num_pages = k_pages.shape[0] // ps
    b, h, d = q.shape
    pps = page_table.shape[1]
    mask = neg_inf_value(torch.float32)
    out = torch.zeros(b, h, d, dtype=torch.float32, device=q.device)
    for s in range(b):
        ctx = min(max(int(ctx_len[s]), 0), pps * ps)
        m_all = torch.full((h,), mask, device=q.device)
        l_all = torch.zeros(h, device=q.device)
        acc = torch.zeros(h, d, device=q.device)
        for c in range(max(1, -(-ctx // chunk_rows))):
            r = torch.arange(c * chunk_rows, min((c + 1) * chunk_rows, ctx),
                             device=q.device)
            page = page_table[s, r // ps].long().clamp(0, num_pages - 1)
            k = k_pages[page * ps + r % ps].float()  # [n, H, D]
            v = v_pages[page * ps + r % ps].float()
            sc = torch.einsum("hd,nhd->hn", q[s].float(), k) * sm_scale
            m = torch.full((h,), mask, device=q.device)
            if len(r):
                m = torch.maximum(m, sc.amax(dim=1))
            p = torch.exp(sc - m[:, None])
            m_new = torch.maximum(m_all, m)
            w, w_c = torch.exp(m_all - m_new), torch.exp(m - m_new)
            l_all = l_all * w + p.sum(dim=1) * w_c
            acc = acc * w[:, None] \
                + torch.einsum("hn,nhd->hd", p, v) * w_c[:, None]
            m_all = m_new
        out[s] = acc / l_all.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)
