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
  ``while_op.cc`` does: the only host sync it adds, and the reason a
  captured step runs a program that holds one eagerly
  (``executor.HOST_OPS``). As under ``lax.while_loop``, there is no
  gradient through it: a carry that depends on a parameter raises the JAX
  package's ``ValueError`` when a gradient reaches it, and a loss that
  does not read the carry trains.
- ``conditional_block`` reads its predicate on the host and runs only the
  branch it selects (``lax.cond`` selects on the device), or keeps the
  outputs as they are when there is no false block; gradients flow
  through the branch that ran.
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


@register_op("while")
def while_op(ctx: OpContext):
    block = _sub_block(ctx, "sub_block")
    cond_name = ctx.op.inputs["Condition"][0]
    carry_names = list(ctx.attr("carry_vars"))
    env = ctx.env

    carry = {n: env[n] for n in carry_names}
    for n, v in carry.items():
        if is_empty_array(v):
            raise ValueError(
                "TensorArray %r is carried through a While loop but was never "
                "written before it — its buffer has no shape yet, which breaks "
                "the loop's fixed carry structure. array_write an init element "
                "(e.g. at index 0) before entering the loop." % n)
    # the condition read on the host: the loop's one sync an iteration
    while bool(carry[cond_name].reshape(())):
        local = dict(env)
        local.update(carry)
        _run_block(ctx, block, local)
        carry = {n: local[n] for n in carry_names}
    # the op's Out slot lists the carry names themselves — rebind them
    for n in carry_names:
        env[n] = _no_reverse(carry[n], carry_names)


@register_op("conditional_block")
def conditional_block_op(ctx: OpContext):
    """Two-branch cond: true_block / false_block attrs, shared output names."""
    pred = ctx.input("Cond").reshape(())
    false_idx = ctx.attr("false_block", -1)
    out_names = ctx.output_names("Out")
    env = ctx.env

    missing = [n for n in out_names if n not in env]
    if false_idx < 0 and missing:
        raise KeyError("conditional_block without a false block keeps its "
                       "outputs as they are, but %s are not materialized"
                       % missing)
    if bool(pred):
        block = _sub_block(ctx, "true_block")
    elif false_idx >= 0:
        block = ctx.trace.program.blocks[false_idx]
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
