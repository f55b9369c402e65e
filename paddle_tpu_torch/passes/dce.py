# ported from paddle_tpu/passes/dce.py
"""Dead-op / dead-var elimination.

Reference: the eager-deletion + graph pruning machinery Fluid spreads over
``framework/prune.cc`` and ``ir/graph_helper.cc`` — remove whole ops the
fetch targets can never observe, before the executor runs the program, so
the eager step (and the CUDA graph captured from it) launches nothing for
them.

Liveness is seeded from the fetch targets plus everything with
externally-visible semantics: persistable writes (param/optimizer-state
updates, streaming-metric accumulators like ``auc``), the loss var (the
Executor differentiates it even when unfetched) and
the LR var. Walking the op list in reverse, an op stays when it writes a
live or persistable var or is opaque (side effects / sub-blocks); its reads
then become live. Everything else — e.g. an ``accuracy`` branch in an eval
program that only fetches the loss, or train-only tail ops in a
``clone(for_test=True)`` graph — is dropped, and vars nothing references
anymore are pruned from the symbol table.
"""

from __future__ import annotations

from ..core.pass_framework import Pass, register_pass
from . import analysis as A

__all__ = ["DeadCodeEliminationPass"]


@register_pass("dead_code_elimination")
class DeadCodeEliminationPass(Pass):
    """attrs: ``fetch_names`` (tuple, may be empty), ``protected`` (set).

    With no fetch info (a build-time application before fetches are known)
    every leaf output — an output no other op consumes — is treated as a
    potential fetch, which makes the pass conservative instead of wrong.
    Reports ``ops_removed`` / ``vars_removed`` attrs for the pipeline.
    """

    def apply_impl(self, program):
        block = program.global_block
        fetch_names = self.attr("fetch_names")
        protected = set(self.attr("protected") or ())
        protected |= A.protected_names(program, fetch_names or ())

        live = set(protected)
        # sub-block ops (while/cond/RNN bodies) read outer vars straight out
        # of the env without listing them on the owning op — every
        # name any non-global block touches is live to the global walk
        for blk in program.blocks:
            if blk is block:
                continue
            for op in blk.ops:
                live.update(op.input_arg_names)
        if fetch_names is None:
            # fetch set unknown: any leaf output may be observed later
            uses = A.use_counts(program)
            for op in block.ops:
                for n in op.output_arg_names:
                    if not uses.get(n):
                        live.add(n)

        known = A.all_var_names(program)
        doomed = set()
        for op in reversed(block.ops):
            keep = (A.is_opaque(op)
                    or any(n in live for n in op.output_arg_names))
            if not keep:
                for n in op.output_arg_names:
                    v = block._find_var_recursive(n)
                    if v is not None and v.persistable:
                        keep = True
                        break
            if keep:
                live.update(op.input_arg_names)
                if A.has_sub_block(op):
                    live.update(A.attr_referenced_names(op, known))
            else:
                doomed.add(id(op))

        removed = A.remove_ops_by_id(block, doomed)
        pruned = A.prune_dead_vars(program, extra_keep=live) if removed else 0
        self.set_attr("ops_removed", removed)
        self.set_attr("vars_removed", pruned)
        return program
