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

import torch

__all__ = ["SparseGrad", "merge_rows"]


class SparseGrad:
    """Gradient of a row-gathered parameter: ``rows[i]`` is the gradient
    contribution of table row ``ids[i]``; duplicate ids accumulate."""

    def __init__(self, ids, rows):
        self.ids = ids
        self.rows = rows

    def __repr__(self):
        return "SparseGrad(ids=%r, rows=%r)" % (self.ids, self.rows)


def merge_rows(ids, rows, invalid_index):
    """Sum rows of duplicate ids. Returns (uniq_ids [N], merged [N, D]):
    the distinct ids in ascending order, each with the sum of its rows,
    then ``invalid_index`` with zero rows up to N.

    A stable sort, a first-of-run mask, a cumsum for each row's segment,
    and a segment sum (``index_add_``) — the JAX package's formulation.
    Rows of one id are summed in their order in ``ids``; on the CPU that
    is the JAX package's order, on a GPU ``index_add_`` adds with atomics
    in an order that may change from run to run."""
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    srows = rows[order]
    first = torch.ones_like(sid, dtype=torch.bool)
    first[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(first, 0) - 1
    merged = torch.zeros_like(rows).index_add_(0, seg, srows)
    uniq = torch.full_like(sid, invalid_index).index_put_((seg,), sid)
    return uniq, merged
