# ported from paddle_tpu/ops/misc_ops.py
"""SelectedRows ops: ``merge_selected_rows`` and
``get_tensor_from_selected_rows``.

Their input is a rows-only gradient (``core.sparse.SparseGrad``, the port's
SelectedRows), as an ``is_sparse`` table's ``p@GRAD`` is. Left out against
the JAX package: the host ops ``print``, ``py_func`` and ``delete_var``.
"""

from __future__ import annotations

from ..core.registry import OpContext, register_op
from ..core.sparse import SparseGrad, merge_rows


def _selected_rows(ctx: OpContext, op: str) -> SparseGrad:
    x = ctx.input("X")
    if not isinstance(x, SparseGrad):
        raise TypeError("%s expects a SelectedRows (SparseGrad) value, got "
                        "%r" % (op, type(x).__name__))
    return x


@register_op("merge_selected_rows")
def merge_selected_rows_op(ctx: OpContext):
    """reference: operators/merge_selected_rows_op.cc — sum rows with
    duplicate ids in a SelectedRows. Static-shape sort+segment-sum
    (core/sparse.py merge_rows); padded tail ids become out-of-range so a
    downstream scatter drops them."""
    x = _selected_rows(ctx, "merge_selected_rows")
    uniq, merged = merge_rows(x.ids, x.rows, invalid_index=2**31 - 1)
    ctx.set_output("Out", SparseGrad(uniq, merged))


@register_op("get_tensor_from_selected_rows")
def get_tensor_from_selected_rows_op(ctx: OpContext):
    """reference: operators/get_tensor_from_selected_rows_op.cc — expose a
    SelectedRows' value block as a dense [N, D] tensor (row i holds the
    contribution of table row ids[i])."""
    x = _selected_rows(ctx, "get_tensor_from_selected_rows")
    ctx.set_output("Out", x.rows)
