# ported from paddle_tpu/core/sparse.py
"""Sparse gradients — the SelectedRows equivalent.

Reference: ``framework/selected_rows.h:32`` (rows + value block) and the
sparse optimizer kernels in ``operators/optimizers/`` (e.g. sgd_op.h's
SelectedRows branch, adam_op.h lazy mode).

A sparse gradient is an explicit ``(ids, rows)`` pair: for an embedding
lookup of N ids into a [V, D] table, the backward produces ``rows`` of
shape [N, D], O(N·D) memory traffic instead of the O(V·D) dense gradient,
which is the entire point at CTR-scale vocabularies (V >= 1e6, N a few
thousand).

``merge_rows`` combines duplicate ids with static shapes (sort + segment
sum): its outputs have N entries whatever the number of distinct ids, and
the tail past the distinct ids carries an out-of-range id (V) that the
row-wise optimizer updates skip. Nothing in it asks the host for a size, so
the launch shapes of a training step never depend on the data.

Left out against the JAX package: ``route_rows_to_shards`` and
``sharded_rows_update`` (the mesh-sharded tables).
"""

from __future__ import annotations

import threading

import torch

__all__ = ["SparseGrad", "merge_rows", "segment_sum"]

# held while a segment sum has torch's deterministic setting on
_DETERMINISTIC = threading.Lock()


class SparseGrad:
    """Gradient of a row-gathered parameter: ``rows[i]`` is the gradient
    contribution of table row ``ids[i]``; duplicate ids accumulate."""

    def __init__(self, ids, rows):
        self.ids = ids
        self.rows = rows

    def __repr__(self):
        return "SparseGrad(ids=%r, rows=%r)" % (self.ids, self.rows)


def segment_sum(ids, rows, num_rows):
    """[num_rows, D]: ``rows`` [N, D] summed by ``ids`` [N] (the table
    gradient of a dense lookup, the segment sum of ``merge_rows``), by
    ``F.embedding``'s own backward under
    ``torch.use_deterministic_algorithms(True)`` for this one call. Left
    to itself that backward sums the rows of an id repeated thousands of
    times (BERT's sentence id 0: 4,096 rows a step) in an order that
    changes between runs on the H100, a few ulp apart, which LAMB's trust
    ratio then spread over the whole state, as ``index_add_``'s atomics
    do for any repeated id; torch's deterministic path gives the same
    bits on every run and stream, 0.03-0.05 ms slower at BERT's and the
    Transformer's lookups on an H100 80GB HBM3 at 700 W
    (``chip_smoke.py``'s ``lookup_determinism``). On the CPU the rows of
    one id are summed in their order in ``ids``.

    The setting is the process's, held for this call only. Two such calls
    on two threads take it in turn (``_DETERMINISTIC``), so each restores
    what it found. An op that another thread launches while it is held
    runs under it too: the same function by torch's deterministic kernel
    where torch has one, else its usual kernel with a warning
    (``warn_only``). The executor's own thread launches nothing
    meanwhile: it makes this call (an optimizer op's ``merge_rows``) or
    waits on the backward that makes it."""
    with _DETERMINISTIC:
        prev = torch.are_deterministic_algorithms_enabled()
        warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            return torch.ops.aten.embedding_dense_backward(
                rows, ids, num_rows, -1, False)
        finally:
            torch.use_deterministic_algorithms(prev, warn_only=warn_only)


def merge_rows(ids, rows, invalid_index):
    """Sum rows of duplicate ids. Returns (uniq_ids [N], merged [N, D]):
    the distinct ids in ascending order, each with the sum of its rows,
    then ``invalid_index`` with zero rows up to N.

    A stable sort, a first-of-run mask, a cumsum for each row's segment,
    and a segment sum (:func:`segment_sum`) — the JAX package's
    formulation. On the CPU the rows of one id are summed in their order
    in ``ids``, the JAX package's order; on a GPU in an order of torch's
    deterministic kernel, the same on every run, so a captured step's
    sparse update gives the bits of the eager step's."""
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    srows = rows[order]
    first = torch.ones_like(sid, dtype=torch.bool)
    first[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(first, 0) - 1
    merged = segment_sum(seg, srows, rows.shape[0])
    uniq = torch.full_like(sid, invalid_index).index_put_((seg,), sid)
    return uniq, merged
