# ported from paddle_tpu/layers/beam_search.py
"""Beam search + TensorArray layers.

Reference API: ``python/paddle/fluid/layers/nn.py`` beam_search /
beam_search_decode and ``layers/control_flow.py`` array_write / array_read /
array_length / create_array (LoDTensorArray ops).

Deviations from Fluid, as in the JAX package (see ops/beam_search_ops.py):
- ``beam_search`` consumes the FULL per-step log-prob tensor ``[B, K, V]``
  (Fluid takes pre-topk'd candidate ids/scores per beam); the batched
  top K over K·V runs on the device and removes the host-side LoD walk.
- TensorArrays are fixed-capacity buffers; pass ``capacity`` (e.g. the
  decode max_len) on the first ``array_write``. There is no dynamic growth:
  writes past capacity are dropped (the write count saturates at capacity
  so ``array_length`` stays truthful) — size ``capacity`` generously.
- An array that is carried through a ``While`` loop must receive its first
  ``array_write`` BEFORE the loop (Fluid's own idiom — the init write at
  i=0): the buffer allocation fixes the loop's carry.
"""

from __future__ import annotations

from typing import Optional

from ..core import unique_name
from .layer_helper import LayerHelper

__all__ = ["beam_search", "beam_search_decode", "create_array", "array_write",
           "array_read", "array_length", "array_to_tensor"]


def create_array(dtype="float32", name=None):
    """reference: layers/control_flow.py create_array."""
    helper = LayerHelper("create_array", name=name)
    out = helper.main_program.current_block().create_var(
        name=unique_name.generate("tensor_array"), dtype=dtype)
    helper.append_op("create_array", inputs={}, outputs={"Out": out}, attrs={})
    out.elem_shape = None
    out.elem_dtype = dtype
    return out


def array_write(x, i, array=None, capacity=512):
    """reference: layers/control_flow.py array_write. Returns the (new)
    array; ``capacity`` bounds the buffer allocated on first write."""
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    helper.append_op(
        "write_to_array", inputs={"X": x, "I": i, "Array": array},
        outputs={"Out": array}, attrs={"capacity": int(capacity)})
    array.elem_shape = x.shape
    array.elem_dtype = x.dtype
    return array


def array_read(array, i):
    """reference: layers/control_flow.py array_read."""
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(
        getattr(array, "elem_dtype", "float32"))
    out.shape = getattr(array, "elem_shape", None)
    helper.append_op("read_from_array", inputs={"Array": array, "I": i},
                     outputs={"Out": out})
    return out


def array_length(array):
    """reference: layers/control_flow.py array_length."""
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64")
    out.shape = (1,)
    helper.append_op("lod_array_length", inputs={"Array": array},
                     outputs={"Out": out})
    return out


def array_to_tensor(array, name=None):
    """Stack the array into a [capacity, ...] tensor + its write count
    (reference: layers/control_flow.py array_to_lod_tensor /
    operators/array_to_lod_tensor_op.cc — LoD re-assembly becomes simple
    stacking under padded+Length)."""
    helper = LayerHelper("array_to_tensor", name=name)
    out = helper.create_variable_for_type_inference(
        getattr(array, "elem_dtype", "float32"))
    elem = getattr(array, "elem_shape", None)
    if elem is not None:
        out.shape = (-1,) + tuple(elem)
    idx = helper.create_variable_for_type_inference("int64")
    idx.shape = (1,)
    helper.append_op("array_to_tensor", inputs={"Array": array},
                     outputs={"Out": out, "OutIndex": idx})
    return out, idx


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id, level=0,
                is_accumulated=False, name=None, return_parent_idx=True):
    """One beam-search step (reference: layers/nn.py beam_search,
    operators/beam_search_op.cc).

    pre_ids/pre_scores: [B, K]; scores: [B, K, V] per-step log-probs
    (``ids`` is accepted for Fluid signature parity and must be None — the
    op expands all K·V candidates itself, as the JAX package's does).
    Returns (selected_ids, selected_scores, parent_idx).
    """
    if ids is not None:
        raise ValueError(
            "beam_search consumes full [B, K, V] log-probs via `scores`; "
            "pass ids=None (pre-topk candidate lists are a LoD-ism)")
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference(pre_ids.dtype)
    sel_scores = helper.create_variable_for_type_inference(pre_scores.dtype)
    parent = helper.create_variable_for_type_inference("int64")
    if pre_ids.shape is not None:
        sel_ids.shape = pre_ids.shape
        sel_scores.shape = pre_ids.shape
        parent.shape = pre_ids.shape
    helper.append_op(
        "beam_search",
        inputs={"PreIds": pre_ids, "PreScores": pre_scores, "Scores": scores},
        outputs={"SelectedIds": sel_ids, "SelectedScores": sel_scores,
                 "ParentIdx": parent},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id),
               "level": int(level), "is_accumulated": bool(is_accumulated)})
    if return_parent_idx:
        return sel_ids, sel_scores, parent
    return sel_ids, sel_scores


def beam_search_decode(ids, scores, beam_size=None, end_id=0, name=None,
                       parents=None):
    """Backtrack a decode run into final sequences (reference: layers/nn.py
    beam_search_decode, operators/beam_search_decode_op.cc).

    ids/parents: TensorArrays written once per step with [B, K] selected ids
    and parent indices; scores: final accumulated [B, K] scores.
    Returns (sentence_ids [B, K, T], sentence_scores [B, K]).
    """
    if parents is None:
        raise ValueError("beam_search_decode needs the parents array "
                         "(Fluid encodes parents in LoD; here they are data)")
    helper = LayerHelper("beam_search_decode", name=name)
    sent_ids = helper.create_variable_for_type_inference("int64")
    sent_scores = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op(
        "beam_search_decode",
        inputs={"Ids": ids, "Parents": parents, "Scores": scores},
        outputs={"SentenceIds": sent_ids, "SentenceScores": sent_scores},
        attrs={"end_id": int(end_id)})
    return sent_ids, sent_scores
