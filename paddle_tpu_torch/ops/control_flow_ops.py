# ported from paddle_tpu/ops/control_flow_ops.py
"""Control-flow ops: while / conditional_block / recurrent (StaticRNN).

Fluid runs sub-blocks through the C++ executor recursively
(``operators/controlflow/while_op.cc``, ``conditional_block_op.cc``,
``recurrent_op.cc``) with scope inheritance. The JAX package lowers them
to ``lax.while_loop``, ``lax.cond`` and ``lax.scan``; the port runs the
sub-block through the interpreter (offset ``10_000 * block.idx``) and
threads the written-variable set as the carry, as the JAX package does
(the body sees ``dict(env)`` updated with the carry; only the carry comes
back).

- ``recurrent`` (StaticRNN) is a Python loop over the static T of its
  step inputs, each unbound once before the loop (one stack as its
  gradient, never a zero-filled [T, ...] tensor a timestep), and trains
  through autograd. It reads nothing on the host, so it captures. A
  dropout inside the step draws the next masks of its one generator every
  timestep (``core/interpreter.py``).
- ``while`` reads its condition on the host once an iteration, as Fluid's
  ``while_op.cc`` does: the loop's one sync an iteration. The captured
  step (``executor._CapturedStep``) replays its body as a CUDA graph of
  its own, once an iteration, with the carry in static buffers
  (:func:`loop_parts`, :func:`write_carry`), and the runs of ops before
  and after the loop as graphs too. As under ``lax.while_loop``, there is
  no gradient through it: a carry that depends on a parameter raises the
  JAX package's ``ValueError`` when a gradient reaches it, and a loss that
  does not read the carry trains.
- ``conditional_block`` run by ``Executor.run`` reads its predicate on the
  host and runs only the branch it selects (Fluid's
  ``conditional_block_op.cc``), or keeps the outputs as they are when
  there is no false block; gradients flow through the branch that ran. In
  the captured step (``trace.both_branches``) both branches run on the
  device and each output is chosen by ``torch.where`` on the predicate,
  the outputs of ``lax.cond``: a branch writes its in-place outputs into
  copies, and each input it reads passes a gate whose backward keeps the
  gradient only when the branch was taken, so a NaN from the other
  branch's backward on a zero gradient never reaches the shared graph.
  The ops draw from generators keyed by their own position, so the
  selected branch draws what it draws eagerly. A branch that holds an op
  indexing by its data (``executor.INDEXING_OPS``) keeps the step eager:
  run untaken, it may see an index out of range, which a CUDA indexing
  kernel answers with a device assert.
"""

from __future__ import annotations

import torch

from ..core.interpreter import run_block_ops
from ..core.registry import OpContext, register_op
from .beam_search_ops import is_empty_array


def _sub_block(ctx: OpContext, attr_name: str):
    return ctx.trace.program.blocks[ctx.attr(attr_name)]


def _run_block(ctx: OpContext, block, local):
    run_block_ops(block.ops, local, ctx.trace, offset=10_000 * block.idx)


class _NoReverse(torch.autograd.Function):
    """Identity forward; a backward that raises, as the JAX package's
    reverse-mode rule for ``lax.while_loop`` does."""

    @staticmethod
    def forward(ctx, x, names):
        ctx.names = names
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        raise ValueError(
            "Reverse-mode differentiation does not work for the `while` "
            "op (it carries %s), as it does not for lax.while_loop in the "
            "JAX package: train a loop with StaticRNN (`recurrent`), and "
            "keep `while` for decoding" % (ctx.names,))


def _no_reverse(value, names):
    if isinstance(value, torch.Tensor):
        return _NoReverse.apply(value, names) if value.requires_grad \
            else value
    if isinstance(value, tuple) and len(value) == 2 \
            and isinstance(value[0], torch.Tensor):
        return (_no_reverse(value[0], names), value[1])
    return value


def loop_parts(program, op):
    """(body block, condition name, carry names) of a ``while`` op."""
    return (program.blocks[op.attrs["sub_block"]], op.inputs["Condition"][0],
            list(op.attrs["carry_vars"]))


def run_body(block, local, trace):
    """One iteration of a loop body on ``local`` (the env updated with the
    carry)."""
    run_block_ops(block.ops, local, trace, offset=10_000 * block.idx)


def _storage(t):
    return t.untyped_storage().data_ptr()


def write_carry(env, local, carry_names):
    """Write an iteration's carry (``local``) back into the static carry
    tensors held in ``env``: a value that is the static tensor itself (an
    in-place write) stays; one that shares storage with any static carry
    tensor is cloned first, so no copy reads a buffer another copy has
    already overwritten. The result is the bits of rebinding the names."""
    held = {n: env[n] for n in carry_names}
    flat = [t for v in held.values()
            for t in (v if isinstance(v, tuple) else (v,))
            if isinstance(t, torch.Tensor)]
    ptrs = {_storage(t) for t in flat}
    pairs = []
    for n in carry_names:
        dst, val = held[n], local[n]
        for d, v in zip(dst if isinstance(dst, tuple) else (dst,),
                        val if isinstance(val, tuple) else (val,)):
            if not isinstance(d, torch.Tensor) or v is d:
                continue
            if d.shape != v.shape:
                raise ValueError(
                    "while: carry %r changed shape in the loop (%s to %s); "
                    "a captured loop keeps its carry in static tensors"
                    % (n, list(d.shape), list(v.shape)))
            pairs.append((d, v.clone() if _storage(v) in ptrs else v))
    for d, v in pairs:
        d.copy_(v)


def check_carry(carry):
    for n, v in carry.items():
        if is_empty_array(v):
            raise ValueError(
                "TensorArray %r is carried through a While loop but was never "
                "written before it — its buffer has no shape yet, which breaks "
                "the loop's fixed carry structure. array_write an init element "
                "(e.g. at index 0) before entering the loop." % n)


@register_op("while")
def while_op(ctx: OpContext):
    block, cond_name, carry_names = loop_parts(ctx.trace.program, ctx.op)
    env = ctx.env

    carry = {n: env[n] for n in carry_names}
    check_carry(carry)
    # the condition read on the host: the loop's one sync an iteration
    while bool(carry[cond_name].reshape(())):
        local = dict(env)
        local.update(carry)
        run_body(block, local, ctx.trace)
        carry = {n: local[n] for n in carry_names}
    # the op's Out slot lists the carry names themselves — rebind them
    for n in carry_names:
        env[n] = _no_reverse(carry[n], carry_names)


class _BranchGate(torch.autograd.Function):
    """Identity forward of a branch input; a backward that passes the
    gradient only when the branch was taken (``where``, so a NaN of the
    untaken branch's backward becomes 0)."""

    @staticmethod
    def forward(ctx, x, taken):
        ctx.save_for_backward(taken)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        taken, = ctx.saved_tensors
        return torch.where(taken, grad, torch.zeros_like(grad)), None


def block_ops(program, block):
    """The ops of ``block`` and of every block nested in it."""
    for op in block.ops:
        yield op
        for key in ("sub_block", "true_block", "false_block"):
            idx = op.attrs.get(key)
            if isinstance(idx, int) and idx >= 0:
                yield from block_ops(program, program.blocks[idx])


def copy_value(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
        return (v[0].clone(),) + tuple(v[1:])
    return v


def _select(pred, t, f, name):
    if isinstance(t, tuple) and isinstance(f, tuple) and len(t) == len(f):
        return tuple(_select(pred, a, b, name) for a, b in zip(t, f))
    if not isinstance(t, torch.Tensor) or not isinstance(f, torch.Tensor):
        if t is f:
            return t
        raise ValueError("conditional_block: the branches give %r as %s and "
                         "%s" % (name, type(t).__name__, type(f).__name__))
    if t.shape != f.shape or t.dtype != f.dtype:
        raise ValueError(
            "conditional_block: the branches give %r as %s %s and %s %s; "
            "both must give one shape and dtype, as lax.cond requires"
            % (name, t.dtype, list(t.shape), f.dtype, list(f.shape)))
    return torch.where(pred, t, f)


def _both_branches(ctx, pred, blocks, out_names):
    """Both branches on the device and each output selected by ``pred``
    (``blocks``: the true block and the false block or None)."""
    env, program = ctx.env, ctx.trace.program
    grad = torch.is_grad_enabled()
    outs = []
    for block, taken in zip(blocks, (pred, ~pred)):
        if block is None:
            outs.append([env[n] for n in out_names])
            continue
        local = dict(env)
        ops = list(block_ops(program, block))
        for n in {n for op in ops for n in op.output_arg_names}:
            if n in local:
                local[n] = copy_value(local[n])
        if grad:
            for n in {n for op in ops for n in op.input_arg_names}:
                v = local.get(n)
                if isinstance(v, torch.Tensor) and v.requires_grad:
                    local[n] = _BranchGate.apply(v, taken)
        _run_block(ctx, block, local)
        outs.append([local[n] for n in out_names])
    for n, t, f in zip(out_names, *outs):
        env[n] = _select(pred, t, f, n)


@register_op("conditional_block")
def conditional_block_op(ctx: OpContext):
    """Two-branch cond: true_block / false_block attrs, shared output names."""
    pred = ctx.input("Cond").reshape(()).bool()
    false_idx = ctx.attr("false_block", -1)
    out_names = ctx.output_names("Out")
    env = ctx.env

    missing = [n for n in out_names if n not in env]
    if false_idx < 0 and missing:
        raise KeyError("conditional_block without a false block keeps its "
                       "outputs as they are, but %s are not materialized"
                       % missing)
    false_block = ctx.trace.program.blocks[false_idx] if false_idx >= 0 \
        else None
    if getattr(ctx.trace, "both_branches", False):
        _both_branches(ctx, pred, (_sub_block(ctx, "true_block"),
                                   false_block), out_names)
        return
    if bool(pred):
        block = _sub_block(ctx, "true_block")
    elif false_block is not None:
        block = false_block
    else:
        return  # no else branch: the outputs stay as they are
    local = dict(env)
    _run_block(ctx, block, local)
    for n in out_names:
        env[n] = local[n]


@register_op("recurrent")
def recurrent_op(ctx: OpContext):
    """StaticRNN over time-major inputs (reference:
    operators/recurrent_op.cc).

    attrs: sub_block, step_inputs [(outer_name, inner_name)], memories
    [(inner_prev_name, updated_inner_name, init_outer_name)], step_outputs
    [inner_name...]; outputs stacked on axis 0 (time-major), FinalStates
    the memories after the last step.
    """
    block = _sub_block(ctx, "sub_block")
    step_inputs = ctx.attr("step_inputs")
    memories = ctx.attr("memories")
    step_outputs = ctx.attr("step_outputs")
    env = ctx.env

    steps = {inner: env[outer].unbind(0) for outer, inner in step_inputs}
    carry = {prev: env[init_name] for prev, _, init_name in memories}
    seq_len = env[step_inputs[0][0]].shape[0] if step_inputs else 0
    ys = [[] for _ in step_outputs]
    for t in range(seq_len):
        local = dict(env)
        local.update({inner: xs[t] for inner, xs in steps.items()})
        local.update(carry)
        _run_block(ctx, block, local)
        carry = {prev: local[updated] for prev, updated, _ in memories}
        for y, n in zip(ys, step_outputs):
            y.append(local[n])
    for n, y in zip(ctx.output_names("Out"), ys):
        env[n] = torch.stack(y, dim=0)
    for (prev, _, _), name in zip(memories, ctx.output_names("FinalStates")):
        env[name] = carry[prev]
