# ported from paddle_tpu/passes/constant_fold.py
"""Constant folding over the Program.

Reference: ``ir/constant_folding_pass`` territory. The port runs every op
eagerly, so a chain like ``fill_constant -> scale -> elementwise_add``
costs a launch per op on every step; folding it at the Program level
leaves one constant op (the JAX package folds for its trace and compile
time instead).

Mechanics: scan the block in order carrying a name -> ndarray environment of
known constants. ``fill_constant`` / ``assign_value`` seed it; any op in the
FOLDABLE whitelist whose inputs are all known is evaluated on CPU tensors
through the port's *registered impl* (exactly the code the executor would
run, so folded values can't diverge from unfolded execution). A folded value
still needed by a surviving op is re-materialized as a single
``fill_constant`` (uniform) or ``assign_value`` op; everything else
vanishes. Outputs larger than ``_MAX_ELEMENTS`` (65536) are never folded —
attrs are host memory. No op that draws from a generator is ever folded
(the whitelist holds none, and the fold's trace refuses a draw).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.pass_framework import Pass, register_pass
from ..core.registry import OpContext, get_op_impl, has_op
from . import analysis as A

__all__ = ["ConstantFoldingPass"]

_MAX_ELEMENTS = 65536


class _FoldTrace:
    """Minimal TraceContext stand-in for evaluating pure ops on the CPU."""

    def __init__(self, program):
        self.program = program
        self.is_test = True
        self.current_op_idx = 0
        self.device = torch.device("cpu")

    def op_rng(self, ctx):  # pragma: no cover - FOLDABLE ops never draw RNG
        raise RuntimeError("constant folder evaluated an RNG-consuming op")


def _try_eval(op, const_env, program):
    """Evaluate ``op`` over numpy constants via its registered impl, on CPU
    tensors. Returns {out_name: ndarray} or None when evaluation is
    unsafe."""
    if op.type in A.RNG_OPS:
        return None
    env = {}
    for n in op.input_arg_names:
        env[n] = torch.from_numpy(np.array(const_env[n]))
    impl = get_op_impl(op.type)
    try:
        with torch.no_grad():
            impl(OpContext(op, env, _FoldTrace(program)))
    except Exception:
        return None
    outs = {}
    for n in op.output_arg_names:
        val = env.get(n)
        if not isinstance(val, torch.Tensor):
            return None  # optional output the impl didn't write
        if val.numel() > _MAX_ELEMENTS or val.dtype == torch.bfloat16:
            return None  # numpy holds no bfloat16
        outs[n] = val.numpy()
    return outs


def _np_dtype_name(arr) -> str:
    from ..core.dtypes import convert_dtype

    try:
        return convert_dtype(arr.dtype)
    except Exception:
        return str(arr.dtype)


def _materialize(block, index, name, arr):
    """Insert one constant op producing ``name`` = ``arr`` at ``index``."""
    dtype = _np_dtype_name(arr)
    if arr.size and (arr == arr.ravel()[0]).all():
        return block.insert_op(
            index, "fill_constant", outputs={"Out": [name]},
            attrs={"shape": list(arr.shape), "dtype": dtype,
                   "value": arr.ravel()[0].item()})
    return block.insert_op(
        index, "assign_value", outputs={"Out": [name]},
        attrs={"shape": list(arr.shape), "dtype": dtype,
               "values": arr.ravel().tolist()})


@register_pass("constant_folding")
class ConstantFoldingPass(Pass):
    """attrs: ``protected`` (names that must keep their defining op as an
    explicit constant rather than disappear), ``fetch_names`` (None when
    fetches are unknown — build-time application — in which case every leaf
    output may be observed later and is kept, mirroring DCE's conservative
    mode). Reports ``ops_removed``."""

    def apply_impl(self, program):
        block = program.global_block
        protected = set(self.attr("protected") or ())
        protected |= A.protected_names(program)
        if self.attr("fetch_names") is None:
            # fetch set unknown: a chain's leaf may be fetched at run time —
            # treat every output nothing in-program reads as protected
            uses = A.use_counts(program)
            for op in block.ops:
                for n in op.output_arg_names:
                    if not uses.get(n):
                        protected.add(n)

        # names any sub-block op writes (loop carries mutate outer vars):
        # their global defs must never be treated as constants
        mutated_elsewhere = set()
        for blk in program.blocks:
            if blk is not block:
                for op in blk.ops:
                    mutated_elsewhere.update(op.output_arg_names)

        const_env = {}        # name -> ndarray (current definition)
        folded_ops = {}       # id(op) -> op, ops whose outputs are all known
        folded_producer = {}  # name -> id(op) of the folded op defining it
        for op in block.ops:
            if op.type in A.MARKER_OPS:
                continue
            # a persistable write is externally visible (the Executor flows
            # it back to the scope) — such ops may SEED the constant env but
            # must never be deleted (e.g. startup fill_constant initializers)
            writes_persistable = any(
                (lambda v: v is not None and v.persistable)(
                    block._find_var_recursive(n))
                for n in op.output_arg_names)
            foldable = False
            if op.type in A.CONST_SOURCE_OPS and not op.input_arg_names:
                foldable = True
            elif (op.type in A.FOLDABLE_OPS and has_op(op.type)
                    and op.input_arg_names
                    and all(n in const_env for n in op.input_arg_names)):
                foldable = True
            if foldable and not any(n in mutated_elsewhere
                                    for n in op.output_arg_names):
                outs = _try_eval(op, const_env, program)
                if outs is not None:
                    const_env.update(outs)
                    if not writes_persistable:
                        folded_ops[id(op)] = op
                        for n in outs:
                            folded_producer[n] = id(op)
                    continue
            # not folded: this op's writes shadow any earlier constant defs —
            # and any folded op defining a now-redefined name must SURVIVE
            # (its materialization slot would otherwise be lost)
            for n in op.output_arg_names:
                const_env.pop(n, None)
                pid = folded_producer.pop(n, None)
                if pid is not None:
                    folded_ops.pop(pid, None)

        if not folded_ops:
            self.set_attr("ops_removed", 0)
            return program

        # A folded var is still NEEDED when a surviving op reads it, an
        # opaque op references it, or it is protected (fetch target etc.).
        known = A.all_var_names(program)
        needed = set(protected)
        for blk in program.blocks:
            for op in blk.ops:
                if blk is block and id(op) in folded_ops:
                    continue
                needed.update(op.input_arg_names)
                if A.has_sub_block(op):
                    needed.update(A.attr_referenced_names(op, known))

        before = len(block.ops)
        new_ops = []
        for op in block.ops:
            if id(op) not in folded_ops:
                new_ops.append(op)
                continue
            for n in op.output_arg_names:
                if n in needed and n in const_env:
                    # splice the constant where the producer stood, keeping
                    # def-before-use order for surviving consumers
                    new_ops.append(_ConstPlaceholder(n, const_env[n]))
        block.ops[:] = [o for o in new_ops
                        if not isinstance(o, _ConstPlaceholder)]
        # materialize placeholders via insert_op (runs shape inference and
        # wires var.op) at their recorded positions, front to back
        for pos, ph in [(i, o) for i, o in enumerate(new_ops)
                        if isinstance(o, _ConstPlaceholder)]:
            _materialize(block, pos, ph.name, ph.value)
        program._version += 1
        removed = before - len(block.ops)
        A.prune_dead_vars(program, extra_keep=needed | set(const_env))
        self.set_attr("ops_removed", removed)
        return program


class _ConstPlaceholder:
    __slots__ = ("name", "value")

    def __init__(self, name, value):
        self.name = name
        self.value = value
