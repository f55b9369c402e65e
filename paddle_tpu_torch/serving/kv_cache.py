# ported from paddle_tpu/serving/kv_cache.py
"""KV-cache layouts for the decode driver: paged block-pool vs contiguous.

Two layouts behind ONE interface (``init_state`` / ``write_token`` /
``write_window`` / ``write_prompt`` / ``context`` / ``decode_attention`` /
``decode_verify``),
so the model's decode loop is layout-blind and the two paths are
comparable bit for bit:

* :class:`PagedKVCache` — KV rows live in a flat page pool ``[n_layer,
  num_pages*page_size, H, D]`` and each slot owns an ordered page table
  ``[slots, pages_per_slot]``. ``context`` gathers a slot's pages back into
  logical order (the gather path), and ``decode_attention`` dispatches
  between that gather and the ragged paged-attention CUDA kernel
  (ops/kernels/paged_attention.py) per ``FLAGS_paged_attention_kernel``.
* :class:`ContiguousKVCache` — the dense reference ``[n_layer, slots,
  max_ctx, H, D]`` every slot pays ``max_ctx`` for.

Unlike the JAX package, whose arrays are immutable, writes here update the
cache tensors IN PLACE (``index_copy_``), which saves a copy of the pool
per write; ``write_*`` return the same state dict for the functional call
shape. The JAX package drops out-of-bounds destination rows
(``.at[].set(mode="drop")``) so inactive slots and padding positions write
nothing; torch has no dropping scatter, so each layout's tensors carry ONE
extra row at the end of the row axis (the pool's row ``num_rows``, a slot's
position ``max_ctx``) that takes those writes and that no read ever sees.
The index math stays the JAX package's; :meth:`PagedKVCache.pools` hands
the kernel a layer's pool without the extra row. Unwritten rows stay zero
in both layouts, which is what makes the gathered contexts bit-identical.

The paged layout also ships pages (``export_pages`` / ``import_pages``):
raw C-order bytes with the JAX package's ``meta`` keys, so a page exported
by one package imports into the other.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.place import resolve_device
from ..ops import attention_ops

__all__ = ["PagedKVCache", "ContiguousKVCache"]

Cache = Dict[str, torch.Tensor]


class _KVCacheBase:
    """Shared geometry: ``max_ctx`` context positions per slot, over
    ``n_layer`` layers of ``n_head`` heads of ``d_head`` lanes, on
    ``device`` (``None``: the card, raising without one)."""

    layout = "base"

    def __init__(self, n_layer: int, n_head: int, d_head: int, slots: int,
                 max_ctx: int, dtype=torch.float32, device=None):
        self.n_layer = int(n_layer)
        self.n_head = int(n_head)
        self.d_head = int(d_head)
        self.slots = int(slots)
        self.max_ctx = int(max_ctx)
        self.dtype = dtype
        self.device = resolve_device(device)

    def cache_bytes(self, state: Cache) -> int:
        return int(state["k"].nbytes + state["v"].nbytes)

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # -- page migration ------------------------------------------------------
    # Only the paged layout ships pages; the dense layout refuses with a
    # typed error (a contiguous slot's KV is not an addressable unit).
    def export_pages(self, state: Cache, pages):
        raise ValueError("layout %r has no pages to export" % self.layout)

    def import_pages(self, state: Cache, pages, meta: dict, blobs):
        raise ValueError("layout %r has no pages to import" % self.layout)


class PagedKVCache(_KVCacheBase):
    layout = "paged"

    def __init__(self, n_layer: int, n_head: int, d_head: int, slots: int,
                 max_ctx: int, page_size: int, num_pages: int,
                 dtype=torch.float32, device=None):
        super().__init__(n_layer, n_head, d_head, slots, max_ctx, dtype,
                         device)
        if max_ctx % page_size != 0:
            raise ValueError("max_ctx=%d must be a multiple of page_size=%d"
                             % (max_ctx, page_size))
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.pages_per_slot = self.max_ctx // self.page_size
        self.num_rows = self.num_pages * self.page_size  # flat KV rows

    def init_state(self) -> Cache:
        # + 1 row: the write sink (module docstring)
        shp = (self.n_layer, self.num_rows + 1, self.n_head, self.d_head)
        return {
            "k": self._zeros(*shp),
            "v": self._zeros(*shp),
            # page table: slot -> ordered page ids; rows beyond a slot's
            # reservation are whatever the allocator last left (reads are
            # masked by length, writes go to the sink row)
            "pt": torch.zeros((self.slots, self.pages_per_slot),
                              dtype=torch.int32, device=self.device),
        }

    def pools(self, state: Cache, layer: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This layer's K and V pools ``[num_rows, H, D]``, contiguous
        views without the sink row."""
        return (state["k"][layer, :self.num_rows],
                state["v"][layer, :self.num_rows])

    # -- decode (one token per slot) -----------------------------------------
    def write_token(self, state: Cache, layer: int, k_new, v_new, pos,
                    active) -> Cache:
        """k_new/v_new [B,H,D] written at logical position ``pos[b]`` of
        slot b; inactive slots write to the sink row."""
        ps = self.page_size
        pt = state["pt"]
        b_idx = torch.arange(pt.shape[0], device=pt.device)
        pidx = (pos // ps).clamp(0, self.pages_per_slot - 1)
        page = pt[b_idx, pidx].long()
        dest = page * ps + pos % ps
        dest = torch.where(active, dest, self.num_rows)
        state["k"][layer].index_copy_(0, dest, k_new)
        state["v"][layer].index_copy_(0, dest, v_new)
        return state

    def write_window(self, state: Cache, layer: int, k_new, v_new, posw,
                     mask) -> Cache:
        """k_new/v_new [B,W,H,D] written at logical positions ``posw[b,
        j]`` of slot b, all W in one scatter; entries with ``mask[b, j]``
        False go to the sink row. The unmasked destinations are distinct
        rows, so this is ``write_token`` over j = 0..W-1 in one launch."""
        ps = self.page_size
        pt = state["pt"]
        b, w = posw.shape
        pidx = (posw // ps).clamp(0, self.pages_per_slot - 1)
        page = pt.gather(1, pidx.long()).long()
        dest = torch.where(mask, page * ps + posw % ps, self.num_rows)
        hd = k_new.shape[2:]
        state["k"][layer].index_copy_(0, dest.reshape(b * w),
                                      k_new.reshape(b * w, *hd))
        state["v"][layer].index_copy_(0, dest.reshape(b * w),
                                      v_new.reshape(b * w, *hd))
        return state

    def _rows(self, state: Cache) -> torch.Tensor:
        """Pool row of every slot's every logical position ``[slots,
        max_ctx]``, page ids clamped to the pool."""
        ps = self.page_size
        pt = state["pt"].long().clamp(0, self.num_pages - 1)
        rows = (pt * ps)[:, :, None] + torch.arange(ps, device=pt.device)
        return rows.reshape(pt.shape[0], self.max_ctx)

    def context(self, state: Cache, layer: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gather every slot's pages back into logical order:
        ``[slots, max_ctx, H, D]`` — the gather path."""
        rows = self._rows(state)
        return state["k"][layer][rows], state["v"][layer][rows]

    def decode_attention(self, state: Cache, layer: int, q, ctx_len,
                         sm_scale: float = 1.0) -> torch.Tensor:
        """One decode-attention step [B,H,D] over this layer's ragged
        contexts. With ``FLAGS_paged_attention_kernel`` armed the paged
        attention wrapper reads K/V straight from the pool through the page
        table (the CUDA kernel for CUDA tensors); otherwise the gather +
        ops.attention_ops.decode_attention path runs. Both mask positions
        >= ctx_len with the SAME neg_inf constant."""
        if attention_ops.paged_kernel_enabled():
            from ..ops.kernels import paged_attention as _pa

            k, v = self.pools(state, layer)
            return _pa.paged_decode_attention(
                q.contiguous(), k, v, state["pt"], ctx_len.to(torch.int32),
                page_size=self.page_size, sm_scale=sm_scale)
        ctx_k, ctx_v = self.context(state, layer)
        return attention_ops.decode_attention(q, ctx_k, ctx_v, ctx_len,
                                              sm_scale=sm_scale)

    def decode_verify(self, state: Cache, layer: int, q, ctx_len,
                      sm_scale: float = 1.0) -> torch.Tensor:
        """Speculative verify-window attention [B,W,H,D] (window position
        j = logical position ctx_len-1+j; the caller wrote all W positions'
        K/V first). Rides the SAME kernel as ``decode_attention`` by
        flattening the window into B*W pseudo-slots, each replaying its
        slot's page table with length ctx_len+j."""
        b, w = q.shape[0], q.shape[1]
        if attention_ops.paged_kernel_enabled():
            from ..ops.kernels import paged_attention as _pa

            lens = ctx_len[:, None] + torch.arange(w, device=q.device)
            lens = lens.reshape(b * w).clamp(0, self.max_ctx)
            k, v = self.pools(state, layer)
            pt = state["pt"]
            # each slot's page table once a window position (an expand,
            # not repeat_interleave: no host-side size, so it captures)
            pt = pt[:, None].expand(b, w, pt.shape[1]).reshape(
                b * w, -1).contiguous()
            out = _pa.paged_decode_attention(
                q.reshape(b * w, self.n_head, self.d_head).contiguous(), k,
                v, pt,
                lens.to(torch.int32), page_size=self.page_size,
                sm_scale=sm_scale)
            return out.reshape(b, w, self.n_head, self.d_head)
        ctx_k, ctx_v = self.context(state, layer)
        return attention_ops.verify_attention(q, ctx_k, ctx_v, ctx_len,
                                              sm_scale=sm_scale)

    # -- prefill (one sequence) ----------------------------------------------
    def prompt_dest(self, pages) -> np.ndarray:
        """Host-side: the ``dest`` operand for ``write_prompt`` — a full
        page-table row (reserved pages first, rest parked on page 0;
        unused entries are never read or written)."""
        row = np.zeros(self.pages_per_slot, np.int32)
        row[:len(pages)] = np.asarray(pages, np.int32)
        return row

    def write_prompt(self, state: Cache, layer: int, k_new, v_new, dest,
                     length) -> Cache:
        """k_new/v_new [S,H,D] for ONE sequence; ``dest`` is its page-table
        row [pages_per_slot] (a tensor on the cache's device); positions
        >= length go to the sink row."""
        ps = self.page_size
        s = k_new.shape[0]
        j = torch.arange(s, device=k_new.device)
        flat = dest.long()[j // ps] * ps + j % ps
        flat = torch.where(j < length, flat, self.num_rows)
        state["k"][layer].index_copy_(0, flat, k_new)
        state["v"][layer].index_copy_(0, flat, v_new)
        return state

    # -- page migration ------------------------------------------------------
    def _page_rows(self, pages) -> np.ndarray:
        p = np.asarray(pages, np.int64)
        return (p[:, None] * self.page_size
                + np.arange(self.page_size)[None, :]).reshape(-1)

    def page_meta(self) -> dict:
        """Geometry a page payload must match to be importable here —
        embedded in every export, checked on every import."""
        return {"layout": self.layout, "n_layer": self.n_layer,
                "n_head": self.n_head, "d_head": self.d_head,
                "page_size": self.page_size,
                "kv_dtype": str(self.dtype).replace("torch.", "")}

    def _check_meta(self, meta: dict, n_blobs: int, blobs) -> None:
        want = self.page_meta()
        got = {k: meta.get(k) for k in want}
        if got != want:
            raise ValueError("page payload geometry mismatch: %r != %r"
                             % (got, want))
        if len(blobs) != n_blobs:
            raise ValueError("page payload has %d blobs, expected %d"
                             % (len(blobs), n_blobs))

    def export_pages(self, state: Cache, pages):
        """Serialize ``pages`` (pool page ids) to ``(meta, blobs)``: raw
        C-order bytes of the K rows then the V rows, ``[n_layer,
        n_pages*page_size, H, D]`` each — bit-exact, no float formatting."""
        rows = torch.as_tensor(self._page_rows(pages), device=self.device)

        def raw(t):
            return t[:, rows].contiguous().view(torch.uint8).cpu().numpy(
                ).tobytes()

        meta = self.page_meta()
        meta["n_pages"] = len(pages)
        return meta, [raw(state["k"]), raw(state["v"])]

    def import_pages(self, state: Cache, pages, meta: dict, blobs) -> Cache:
        """Write an exported payload into ``pages`` of THIS pool (in
        place); raises ``ValueError`` (typed, caller frees its
        reservation) on any geometry/dtype/size mismatch. Row bytes land
        verbatim, so an export of the same pages round-trips
        bit-identical."""
        self._check_meta(meta, 2, blobs)
        n = int(meta.get("n_pages", -1))
        if n != len(pages):
            raise ValueError("page payload has %d pages, caller reserved %d"
                             % (n, len(pages)))
        rows_np = self._page_rows(pages)
        shp = (self.n_layer, len(rows_np), self.n_head, self.d_head)
        want = int(np.prod(shp)) * self.dtype.itemsize
        if len(blobs[0]) != want or len(blobs[1]) != want:
            raise ValueError("page payload blob bytes %d/%d != %d"
                             % (len(blobs[0]), len(blobs[1]), want))
        rows = torch.as_tensor(rows_np, device=self.device)
        for name, blob in (("k", blobs[0]), ("v", blobs[1])):
            t = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
            state[name][:, rows] = t.view(self.dtype).reshape(shp).to(
                self.device)
        return state


class ContiguousKVCache(_KVCacheBase):
    layout = "contiguous"

    def init_state(self) -> Cache:
        # + 1 position per slot: the write sink (module docstring)
        shp = (self.n_layer, self.slots, self.max_ctx + 1, self.n_head,
               self.d_head)
        return {"k": self._zeros(*shp), "v": self._zeros(*shp)}

    def write_token(self, state: Cache, layer: int, k_new, v_new, pos,
                    active) -> Cache:
        b_idx = torch.arange(pos.shape[0], device=pos.device)
        pos_c = torch.where(active, pos, self.max_ctx).long()
        state["k"][layer].index_put_((b_idx, pos_c), k_new)
        state["v"][layer].index_put_((b_idx, pos_c), v_new)
        return state

    def write_window(self, state: Cache, layer: int, k_new, v_new, posw,
                     mask) -> Cache:
        """``write_token`` over the W window positions in one scatter
        (masked entries to the sink position)."""
        b, w = posw.shape
        b_idx = torch.arange(b, device=posw.device)[:, None].expand(b, w)
        pos_c = torch.where(mask, posw, self.max_ctx).long()
        state["k"][layer].index_put_((b_idx, pos_c), k_new)
        state["v"][layer].index_put_((b_idx, pos_c), v_new)
        return state

    def context(self, state: Cache, layer: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (state["k"][layer, :, :self.max_ctx],
                state["v"][layer, :, :self.max_ctx])

    def decode_attention(self, state: Cache, layer: int, q, ctx_len,
                         sm_scale: float = 1.0) -> torch.Tensor:
        """Dense layout has no gather to fuse away — always the plain path
        (the yardstick the paged kernel is held against)."""
        ctx_k, ctx_v = self.context(state, layer)
        return attention_ops.decode_attention(q, ctx_k, ctx_v, ctx_len,
                                              sm_scale=sm_scale)

    def decode_verify(self, state: Cache, layer: int, q, ctx_len,
                      sm_scale: float = 1.0) -> torch.Tensor:
        ctx_k, ctx_v = self.context(state, layer)
        return attention_ops.verify_attention(q, ctx_k, ctx_v, ctx_len,
                                              sm_scale=sm_scale)

    def prompt_dest(self, slot: int) -> np.int32:
        return np.int32(slot)

    def write_prompt(self, state: Cache, layer: int, k_new, v_new, dest,
                     length) -> Cache:
        """``dest`` is the slot (an int, or a tensor of one element on the
        cache's device: no host read, so a captured prefill takes it)."""
        s = k_new.shape[0]
        j = torch.arange(s, device=k_new.device)
        pos_c = torch.where(j < length, j, self.max_ctx)
        slot = torch.as_tensor(dest, device=k_new.device).reshape(1).long()
        state["k"][layer].index_put_((slot.expand(s), pos_c), k_new)
        state["v"][layer].index_put_((slot.expand(s), pos_c), v_new)
        return state
