# ported from paddle_tpu/ops/beam_search_ops.py
"""Beam search and TensorArray ops.

Reference: ``operators/beam_search_op.cc``, ``operators/math/beam_search.cu``,
``operators/beam_search_decode_op.cc`` and the TensorArray read/write ops
(``operators/controlflow/tensor_array_read_write_op.cc``,
``operators/lod_array_length_op.cc``).

As in the JAX package:

- one beam-search step is a batched top K over ``[B, K·V]``: no LoD walk
  on the host, the number of live beams is static;
- a LoDTensorArray is a ``(buffer [capacity, ...], count)`` pair, the
  buffer allocated on the first write and the count a 0-d int32 tensor on
  the buffer's device;
- ``beam_search_decode`` backtracks the parent pointers over the static
  capacity, masking the steps past the count.

Nothing here reads a device value on the host, so every op runs inside a
captured step. An index out of range never reaches a CUDA indexing
kernel (whose bounds check is a device assert that poisons the context):
a write past the capacity is dropped, as XLA drops an out-of-bounds
scatter, by blending the old row back in at a clamped index, and the count
saturates at the capacity; a read clamps its index, as XLA clamps a
gather's. A negative index counts from the end first, as in ``jnp``.

A write is out of place when autograd may need the old buffer (an array
read by a StaticRNN that trains: grad mode on and the row or the buffer
requiring grad), else in place (``index_copy_``): one kernel for the row
and one for the copy either way, and out of place one more copy of the
buffer a write. ``array_to_tensor`` hands out a copy of the buffer, so a
later in-place write does not reach a tensor taken before it.

``tensor_array_to_tensor`` concatenates the full capacity; ``OutIndex``
gives each entry's extent, 0 for unwritten slots.
"""

from __future__ import annotations

import torch

from ..core.registry import OpContext, register_op

# sentinel env value for a created-but-never-written array
EMPTY_ARRAY = ("__empty_tensor_array__",)


def is_empty_array(value) -> bool:
    return isinstance(value, tuple) and value == EMPTY_ARRAY


def _index(ctx: OpContext, size: int):
    """The op's ``I`` as a 0-d int32 device tensor, a negative index
    counted from the end of ``size``: (raw, normalised)."""
    i = ctx.input("I").reshape(()).to(torch.int32)
    return i, torch.where(i < 0, i + size, i)


def _array(ctx: OpContext, slot: str):
    value = ctx.input(slot)
    if value is None or is_empty_array(value):
        raise ValueError(
            "op %r reads TensorArray %r, which was never written: "
            "array_write an element first"
            % (ctx.op.type, ctx.op.inputs[slot][0]))
    return value


@register_op("create_array")
def create_array_op(ctx: OpContext):
    ctx.set_output("Out", EMPTY_ARRAY)


@register_op("write_to_array")
def write_to_array_op(ctx: OpContext):
    x = ctx.input("X")
    arr = ctx.input("Array")
    capacity = int(ctx.attr("capacity", 512))
    if arr is None or is_empty_array(arr):
        buf = x.new_zeros((capacity,) + tuple(x.shape))
        count = torch.zeros((), dtype=torch.int32, device=x.device)
    else:
        buf, count = arr
    cap = buf.shape[0]
    i, at = _index(ctx, cap)
    slot = at.clamp(0, cap - 1)
    keep = slot == at
    slot = slot.reshape(1).long()
    # a write past the capacity puts the row's own value back
    row = torch.where(keep, x.to(buf.dtype), buf.index_select(0, slot)[0])
    if torch.is_grad_enabled() and (x.requires_grad or buf.requires_grad):
        buf = buf.index_copy(0, slot, row.unsqueeze(0))
    else:
        buf.index_copy_(0, slot, row.unsqueeze(0))
    count = torch.clamp(torch.maximum(count, i + 1), max=cap)
    ctx.set_output("Out", (buf, count))


@register_op("read_from_array")
def read_from_array_op(ctx: OpContext):
    buf, _count = _array(ctx, "Array")
    _, at = _index(ctx, buf.shape[0])
    slot = at.clamp(0, buf.shape[0] - 1).reshape(1).long()
    ctx.set_output("Out", buf.index_select(0, slot)[0])


@register_op("lod_array_length")
def lod_array_length_op(ctx: OpContext):
    _buf, count = _array(ctx, "Array")
    ctx.set_output("Out", count.reshape(1).to(torch.int32))


@register_op("array_to_tensor")
def array_to_tensor_op(ctx: OpContext):
    """Stack a TensorArray into one tensor [capacity, ...] (the
    array_to_lod_tensor analog: padding past the write count stays zero;
    the count is emitted for masking)."""
    buf, count = _array(ctx, "Array")
    ctx.set_output("Out", buf.clone())
    ctx.set_output("OutIndex", count.reshape(1).to(torch.int32))


@register_op("beam_search")
def beam_search_op(ctx: OpContext):
    """One beam-search step, fully batched (reference: beam_search_op.cc).

    PreIds/PreScores [B, K]; Scores = per-step log-probs [B, K, V].
    Finished beams (pre_id == end_id) survive with unchanged score and emit
    end_id again; everything else expands to K·V candidates and the top K
    per batch row win, in ``jax.lax.top_k``'s order (a stable descending
    sort: the lower index first among equal scores, which the -1e9 of a
    finished or unborn beam makes common). ParentIdx (int32) records which
    source beam each winner came from, for beam_search_decode's backtrack.
    """
    pre_ids = ctx.input("PreIds")
    pre_scores = ctx.input("PreScores")
    scores = ctx.input("Scores")
    end_id = int(ctx.attr("end_id", 0))
    B, K, V = scores.shape

    finished = (pre_ids == end_id)[..., None]  # [B, K, 1]
    if ctx.attr("is_accumulated", False):
        total = scores  # caller already folded pre_scores in
    else:
        total = pre_scores[..., None] + scores  # [B, K, V]
    # finished beams: single candidate (end_id, pre_score)
    end_col = torch.arange(V, device=scores.device) == (
        end_id + V if end_id < 0 else end_id)
    finished_row = torch.where(end_col, pre_scores[..., None],
                               torch.full((), -1e9, dtype=total.dtype,
                                          device=total.device))
    total = torch.where(finished, finished_row.to(total.dtype), total)

    flat = total.reshape(B, K * V)
    top_scores, top_idx = torch.sort(flat, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :K], top_idx[:, :K]
    ctx.set_output("SelectedIds", (top_idx % V).to(pre_ids.dtype))
    ctx.set_output("SelectedScores", top_scores)
    ctx.set_output("ParentIdx", (top_idx // V).to(torch.int32))


@register_op("beam_search_decode")
def beam_search_decode_op(ctx: OpContext):
    """Backtrack stacked (ids, parents) into full sequences
    (reference: beam_search_decode_op.cc).

    Ids/Parents: TensorArray values ((buffer [cap,B,K], count)) or plain
    stacked [T,B,K] tensors. Outputs SentenceIds [B,K,T_cap] padded with
    end_id past each sequence's length, plus SentenceScores [B,K]. A
    Python loop over the static capacity, backwards, with the count a
    device tensor."""
    ids_in = ctx.input("Ids")
    parents_in = ctx.input("Parents")
    scores = ctx.input("Scores")
    end_id = int(ctx.attr("end_id", 0))

    # a plain stacked tensor: every step is valid
    ids_buf, count = _array(ctx, "Ids") if isinstance(ids_in, tuple) \
        else (ids_in, None)
    parents_buf = _array(ctx, "Parents")[0] \
        if isinstance(parents_in, tuple) else parents_in

    cap, B, K = ids_buf.shape
    cur = torch.arange(K, device=ids_buf.device).expand(B, K)
    ids_t, parents_t = ids_buf.unbind(0), parents_buf.unbind(0)
    outs = []
    for t in range(cap - 1, -1, -1):
        # a parent out of [0, K) is clamped, as XLA clamps a gather
        at = torch.where(cur < 0, cur + K, cur).clamp(0, K - 1)
        id_t = ids_t[t].gather(1, at)
        par_t = parents_t[t].gather(1, at).to(at.dtype)
        if count is None:
            outs.append(id_t)
            cur = par_t
            continue
        valid = count > t
        outs.append(torch.where(valid, id_t, torch.full(
            (), end_id, dtype=id_t.dtype, device=id_t.device)))
        cur = torch.where(valid, par_t, cur)
    outs.reverse()
    ctx.set_output("SentenceIds", torch.stack(outs, dim=2))
    ctx.set_output("SentenceScores", scores)


@register_op("tensor_array_to_tensor")
def tensor_array_to_tensor_op(ctx: OpContext):
    """Concatenate TensorArray entries along ``axis`` (reference:
    operators/tensor_array_to_tensor_op.cc). Static-shape contract (the
    padded+Length convention): the concat spans the array's full capacity —
    slots past the write count hold zeros — and OutIndex carries each
    entry's extent along the axis, 0 for unwritten slots, so consumers mask
    exactly like every Length-carrying op here. Size the array's capacity
    to the real entry count to avoid padding (create_array/array_write)."""
    buf, count = _array(ctx, "X")
    axis = ctx.attr("axis", 1)
    k = buf.shape[0]
    ctx.set_output("Out", torch.cat(buf.unbind(0), dim=axis))
    extent = buf.shape[1:][axis]
    ctx.set_output("OutIndex", torch.where(
        torch.arange(k, device=buf.device) < count,
        extent, 0).to(torch.int32))
