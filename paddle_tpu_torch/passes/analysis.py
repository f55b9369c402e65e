# ported from paddle_tpu/passes/analysis.py
"""Shared graph analysis for the default trace-time optimizer passes.

The reference's ir passes each re-derive graph facts from the ``ir::Graph``
node links (``framework/ir/graph_helper.cc``); here the Program IS the IR
(op list + var table, ``core/framework.py``), so the facts every pass needs
— who consumes a var, who defines it, which ops may draw RNG or carry side
effects — live in one module instead of being re-scanned per pass.

RNG stability contract
----------------------
Stochastic ops seed their ``torch.Generator`` from the op's *position* in
the block (``executor.TraceContext.op_rng``). An optimizer that deletes a
dead op ahead of a ``dropout`` would silently shift every later stream —
losses would differ from the unoptimized program for no semantic reason.
Before any pass mutates a program, :func:`stamp_rng_slots` freezes each
stochastic op's original position into a ``__rng_slot__`` attr;
``op_rng`` keys the generator by the stamp, so op deletion and motion never
perturb the RNG stream and optimized losses stay bit-identical to
``PADDLE_TPU_OPT_LEVEL=0``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set

__all__ = [
    "RNG_OPS", "SIDE_EFFECT_OPS", "MARKER_OPS", "CSE_PURE_OPS", "FOLDABLE_OPS",
    "has_sub_block", "is_opaque", "use_counts", "producer_map",
    "attr_referenced_names", "stamp_rng_slots", "stamp_op_slots",
    "protected_names", "remove_ops_by_id", "prune_dead_vars",
]

# Ops that draw from the per-step generator (ctx.rng()). Their
# position-derived stream is frozen by stamp_rng_slots before the first
# rewrite.
RNG_OPS = frozenset({
    "dropout", "scaled_dot_product_attention",
    "uniform_random", "uniform_random_batch_size_like",
    "gaussian_random", "gaussian_random_batch_size_like",
    "truncated_gaussian_random", "randint",
    "sampling_id", "random_crop", "shuffle_channel",
    "nce", "sample_logits", "lstm",
    "rpn_target_assign", "generate_proposal_labels", "generate_mask_labels",
})

# Structural markers the Executor itself interprets — never remove, never CSE.
MARKER_OPS = frozenset({"backward_marker", "feed", "fetch"})

# Ops whose effect is not captured by their output list (host I/O, state the
# liveness walk can't see). Conservative: kept live, inputs kept live.
SIDE_EFFECT_OPS = frozenset({
    "print", "py_func", "save", "load", "read",
    "while", "conditional_block", "recurrent", "assert",
})

# Attr keys that reference sub-blocks; ops carrying one are opaque to the
# optimizer (their body may read anything — treat every referenced name live).
_BLOCK_ATTR_KEYS = ("sub_block", "true_block", "false_block")

# Pure, deterministic, single-assignment-friendly ops safe to deduplicate.
# Whitelist, not blacklist: an op type not listed is simply never CSE'd.
CSE_PURE_OPS = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_pow", "elementwise_max", "elementwise_min", "elementwise_mod",
    "elementwise_floordiv",
    "scale", "cast", "clip", "sign", "mean", "sum",
    "mul", "matmul", "softmax", "log_softmax",
    "relu", "relu6", "sigmoid", "tanh", "gelu", "elu", "leaky_relu",
    "exp", "log", "sqrt", "rsqrt", "square", "abs", "pow", "floor", "ceil",
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
    "reshape", "reshape2", "transpose", "transpose2",
    "squeeze", "squeeze2", "unsqueeze", "unsqueeze2", "flatten", "flatten2",
    "concat", "stack", "split", "slice", "strided_slice",
    "gather", "gather_nd", "one_hot", "expand", "expand_as", "tile",
    "fill_constant", "fill_zeros_like", "assign", "assign_value", "shape",
    "arg_max", "arg_min", "top_k", "lookup_table",
    "equal", "not_equal", "less_than", "less_equal",
    "greater_than", "greater_equal",
    "logical_and", "logical_or", "logical_not", "logical_xor",
    "layer_norm", "cross_entropy", "softmax_with_cross_entropy",
    "pad", "pad2d", "where", "cos", "sin",
})

# Ops the constant folder may host-evaluate when every input is a known
# compile-time constant. Strictly deterministic, attr/shape-static subset.
FOLDABLE_OPS = frozenset({
    "scale", "cast", "sign", "clip",
    "elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_pow", "elementwise_max", "elementwise_min",
    "exp", "log", "sqrt", "rsqrt", "square", "abs", "floor", "ceil",
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
    "reshape", "reshape2", "transpose", "transpose2",
    "squeeze", "squeeze2", "unsqueeze", "unsqueeze2", "flatten", "flatten2",
    "concat", "stack", "one_hot", "expand", "tile",
    "fill_zeros_like", "assign", "range", "linspace", "mean", "sum",
})

# Constant *sources*: ops with no data inputs whose output is fully
# determined by attrs.
CONST_SOURCE_OPS = frozenset({"fill_constant", "assign_value"})


def has_sub_block(op) -> bool:
    return any(k in op.attrs for k in _BLOCK_ATTR_KEYS)


def is_opaque(op) -> bool:
    """True when the optimizer must neither remove nor rewrite this op."""
    return (op.type in MARKER_OPS or op.type in SIDE_EFFECT_OPS
            or has_sub_block(op))


def attr_referenced_names(op, known: Set[str]) -> List[str]:
    """Var names an opaque op references through attrs (control-flow ops
    carry (outer, inner) name pairs in attrs like ``carry_vars`` /
    ``step_inputs`` rather than input slots). Conservative: every attr
    string (or string inside a list/tuple of strings/pairs) that names a
    known var counts as a reference."""
    refs = []
    for v in op.attrs.values():
        if isinstance(v, str):
            if v in known:
                refs.append(v)
        elif isinstance(v, (list, tuple)):
            for item in v:
                if isinstance(item, str):
                    if item in known:
                        refs.append(item)
                elif isinstance(item, (list, tuple)):
                    for s in item:
                        if isinstance(s, str) and s in known:
                            refs.append(s)
    return refs


def use_counts(program) -> Dict[str, int]:
    """name -> number of reading references across ALL blocks (input slots
    plus attr refs of opaque ops). One linear scan; passes that mutate the
    program maintain their copy incrementally or rebuild."""
    known = all_var_names(program)
    counts: Dict[str, int] = {}
    for blk in program.blocks:
        for op in blk.ops:
            for n in op.input_arg_names:
                counts[n] = counts.get(n, 0) + 1
            if has_sub_block(op):
                for n in attr_referenced_names(op, known):
                    counts[n] = counts.get(n, 0) + 1
    return counts


def all_var_names(program) -> Set[str]:
    names: Set[str] = set()
    for blk in program.blocks:
        names.update(blk.vars)
    return names


def producer_map(block) -> Dict[str, object]:
    """name -> LAST op in the block writing it (matching trace-time
    semantics, where later writes shadow earlier ones in the env)."""
    prod: Dict[str, object] = {}
    for op in block.ops:
        for n in op.output_arg_names:
            prod[n] = op
    return prod


def stamp_op_slots(program) -> None:
    """Freeze every op's original position into ``__op_slot__`` — the op's
    identity in the SOURCE program's numbering, which op deletion/motion by
    the passes never shifts (the JAX package labels its named scopes and
    numerics reports with it).
    Idempotent (already-stamped ops keep their slot); ops inserted by
    later rewrites carry no stamp and fall back to their position.
    CSE ignores ``__*__`` framework attrs when value-numbering, so the
    stamp can never block a merge (cse.py ``_attr_key``)."""
    for i, op in enumerate(program.global_block.ops):
        if "__op_slot__" not in op.attrs:
            op.attrs["__op_slot__"] = i


def stamp_rng_slots(program) -> None:
    """Freeze every stochastic op's positional PRNG identity (see module
    docstring). Idempotent: already-stamped ops are left alone, so
    re-optimizing an optimized program (or composing user passes after the
    default pipeline) never re-derives. (The JAX package also records the
    source op count, the size of its key table; the port's generators,
    one a slot, need none.)"""
    for i, op in enumerate(program.global_block.ops):
        if op.type in RNG_OPS and "__rng_slot__" not in op.attrs:
            op.attrs["__rng_slot__"] = i


def protected_names(program, fetch_names: Iterable[str] = ()) -> Set[str]:
    """Vars no pass may eliminate or alias away: fetch targets, the loss
    (the Executor differentiates it), the grad-norm probe, the LR var, and
    every gradient name the backward info wires up out-of-band. (The JAX
    package also protects its grad-norm probe var; the port has none.)"""
    prot = set(fetch_names or ())
    bw = getattr(program, "_backward_info", None)
    if bw:
        if bw.get("loss"):
            prot.add(bw["loss"])
        if bw.get("loss_grad"):
            prot.add(bw["loss_grad"])
        for p, g in (bw.get("param_to_grad") or {}).items():
            prot.add(p)
            prot.add(g)
    if getattr(program, "_lr_var_name", None):
        prot.add(program._lr_var_name)
    return prot


def remove_ops_by_id(block, doomed_ids: Set[int]) -> int:
    """Drop every op whose id() is in ``doomed_ids``; returns count."""
    kept = [op for op in block.ops if id(op) not in doomed_ids]
    removed = len(block.ops) - len(kept)
    if removed:
        block.ops[:] = kept
        block.program._version += 1
    return removed


def prune_dead_vars(program, extra_keep: Optional[Set[str]] = None) -> int:
    """Delete block vars nothing references anymore: not persistable, not
    feed data, not produced/consumed by any remaining op in any block, not
    attr-referenced, not protected. Returns the number pruned."""
    keep = set(extra_keep or ())
    known = all_var_names(program)
    referenced: Set[str] = set()
    for blk in program.blocks:
        for op in blk.ops:
            referenced.update(op.input_arg_names)
            referenced.update(op.output_arg_names)
            if has_sub_block(op):
                referenced.update(attr_referenced_names(op, known))
    pruned = 0
    for blk in program.blocks:
        for name in list(blk.vars):
            v = blk.vars[name]
            if (name in referenced or name in keep or v.persistable
                    or getattr(v, "is_data", False)):
                continue
            del blk.vars[name]
            pruned += 1
    if pruned:
        program._version += 1
    return pruned
