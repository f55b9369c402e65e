# ported from paddle_tpu/passes/cse.py
"""Common-subexpression elimination over the Program op list.

Two ops compute the same value when they have the same type, the same
*value-numbered* inputs (not just the same names — a var redefined between
the two occurrences gets a fresh value number, so in-place reassignment
patterns can never be merged wrongly) and equal attrs. Only ops in the
``CSE_PURE_OPS`` whitelist participate: stochastic ops (dropout & friends)
each own a distinct PRNG slot, and side-effecting or sub-block ops are
opaque. The duplicate op is deleted and later readers of its outputs are
redirected to the first occurrence's outputs.

Typical wins in ported Fluid scripts: repeated mask/bias construction
(every attention layer re-building the same ``scale``/``expand`` chain from
the same input mask), duplicate ``fill_constant``\\ s, repeated
``reshape2``/``transpose2`` of a shared activation.
"""

from __future__ import annotations

from ..core.pass_framework import Pass, register_pass
from . import analysis as A

__all__ = ["CommonSubexpressionEliminationPass"]


def _attr_key(attrs):
    items = []
    for k in sorted(attrs):
        if k.startswith("__") and k.endswith("__"):
            # framework-private stamps (__op_slot__, __rng_slot__) carry
            # per-op IDENTITY, not semantics — keying on them would make
            # every stamped op unique and defeat CSE entirely
            continue
        v = attrs[k]
        try:
            hash(v)
        except TypeError:
            v = repr(v)
        items.append((k, v))
    return tuple(items)


@register_pass("common_subexpression_elimination")
class CommonSubexpressionEliminationPass(Pass):
    """attrs: ``protected`` — vars whose defining op must survive (fetch
    targets etc.); ``fetch_names`` — None when fetches are unknown (leaf
    outputs are then protected, like DCE's conservative mode: merging away
    a leaf would make its name unfetchable at run time).
    Reports ``ops_removed``."""

    def apply_impl(self, program):
        block = program.global_block
        protected = set(self.attr("protected") or ())
        protected |= A.protected_names(program)
        if self.attr("fetch_names") is None:
            uses0 = A.use_counts(program)
            for op in block.ops:
                for n in op.output_arg_names:
                    if not uses0.get(n):
                        protected.add(n)

        value_num = {}   # var name -> value number of its current definition
        next_vn = [0]

        def vn_of(name):
            if name not in value_num:
                # external def (feed, state, startup-initialized param):
                # stable for the whole block scan
                value_num[name] = ("ext", name)
            return value_num[name]

        # names read by other blocks or through opaque attrs: the aliasing
        # rewrite below can't reach those readers, so their defining ops
        # must never be merged away
        known = A.all_var_names(program)
        outer_refs = set()
        for blk in program.blocks:
            for op in blk.ops:
                if blk is not block:
                    outer_refs.update(op.input_arg_names)
                if A.has_sub_block(op):
                    outer_refs.update(A.attr_referenced_names(op, known))

        exprs = {}    # expr key -> (first op, its outputs' value numbers)
        alias = {}    # replaced var name -> canonical var name
        doomed = set()
        removed = 0
        for op in block.ops:
            # redirect reads through aliases established by earlier merges
            if alias:
                for slot, names in op.inputs.items():
                    if any(n in alias for n in names):
                        op.inputs[slot] = [alias.get(n, n) for n in names]

            eligible = (
                op.type in A.CSE_PURE_OPS
                and not A.has_sub_block(op)
                and op.output_arg_names
                and not any(n in protected for n in op.output_arg_names)
                and not any(n in outer_refs for n in op.output_arg_names)
                and not any(
                    (lambda v: v is not None and v.persistable)(
                        block._find_var_recursive(n))
                    for n in op.output_arg_names)
                # in-place op (an output aliasing an input) — don't touch
                and not (set(op.output_arg_names) & set(op.input_arg_names)))

            key = None
            if eligible:
                key = (
                    op.type,
                    tuple((slot, tuple(vn_of(n) for n in names))
                          for slot, names in sorted(op.inputs.items())),
                    tuple(sorted(op.outputs)),  # same output arity/slots
                    _attr_key(op.attrs),
                )
                hit = exprs.get(key)
                if hit is not None:
                    first, first_vns = hit
                    # the first occurrence's outputs must still hold their
                    # original values (no redefinition in between)
                    if all(value_num.get(n) == vn
                           for n, vn in zip(first.output_arg_names,
                                            first_vns)):
                        for slot, names in op.outputs.items():
                            for mine, theirs in zip(names,
                                                    first.outputs[slot]):
                                if mine != theirs:
                                    alias[mine] = theirs
                        doomed.add(id(op))
                        removed += 1
                        continue

            # assign new value numbers to this op's definitions — and kill
            # any alias whose replaced name this op redefines (later readers
            # must see the NEW definition, not the stale first occurrence)
            for n in op.output_arg_names:
                value_num[n] = next_vn[0]
                next_vn[0] += 1
                alias.pop(n, None)
            if key is not None:
                exprs[key] = (op, tuple(value_num[n]
                                        for n in op.output_arg_names))

        if removed:
            A.remove_ops_by_id(block, doomed)
            # opaque sub-block ops may reference aliased names through attrs;
            # those references were left untouched, so keep the aliased vars
            # only if still referenced — prune handles it
            A.prune_dead_vars(program, extra_keep=protected)
        self.set_attr("ops_removed", removed)
        return program
