# ported from paddle_tpu/ops/gradient_ops.py
"""calc_gradient op: d(targets)/d(inputs) inside the step
(``fluid.gradients``).

Reference: ``python/paddle/fluid/backward.py:613`` (``calc_gradient``) —
Fluid walks the forward ops in reverse appending grad ops between targets
and inputs. As in the JAX package, the op replays the slice of the op
prefix that produces the targets as a function of the requested inputs,
and differentiates it: ``torch.autograd.grad`` with ``create_graph=True``,
so a later marker whose prefix holds an earlier one differentiates through
it (the double-grad idiom), and a loss built from the gradients trains
through them.

Semantics, as in the JAX package:
- each requested input is a leaf: the slice is cut there, so gradients do
  not flow through it to upstream producers;
- inputs with no path to any target get zero gradients;
- ``no_grad_set`` variables are detached as soon as they are produced.

The replay runs with grad enabled whatever the step's mode, on a trace
with fresh generators seeded for the step, so a stochastic op draws what
it drew in the forward. The slice is computed twice (once in the forward,
once in the replay); the JAX package's compiler merges the two.
"""

from __future__ import annotations

import torch

from ..core.interpreter import SKIP_OPS
from ..core.registry import OpContext, get_op_impl, register_op


def _backward_slice(prefix, target_names, input_names):
    """The ops of ``prefix`` that transitively produce the targets, cut at
    the inputs, as (index, op), in program order. A reverse walk keeps the
    last producer of each needed name and leaves out the training tail
    (backward marker, optimizer updates)."""
    input_set = set(input_names)
    needed = set(target_names) - input_set
    sliced = []
    for i in range(len(prefix) - 1, -1, -1):
        o = prefix[i]
        if o.type in SKIP_OPS:
            continue
        outs = set(o.output_arg_names)
        if outs & needed:
            sliced.append((i, o))
            needed -= outs
            needed.update(o.input_arg_names)
            needed -= input_set
    sliced.reverse()
    return sliced


@register_op("calc_gradient")
def calc_gradient_op(ctx: OpContext):
    from ..core.enforce import EnforceNotMet, wrap_op_error
    from ..executor import TraceContext

    op = ctx.op
    ops = op.block.ops
    my_idx = next(i for i, o in enumerate(ops) if o is op)
    target_names = list(op.attrs["targets"])
    input_names = list(op.attrs["inputs"])
    tg_names = list(op.attrs.get("target_gradients")
                    or [None] * len(target_names))
    no_grad = frozenset(op.attrs.get("no_grad_set") or ())
    sliced = _backward_slice(ops[:my_idx], target_names, input_names)
    written = {n for _, o in sliced for n in o.output_arg_names}
    env = {k: v for k, v in ctx.env.items() if k not in written}
    with torch.enable_grad():
        # a leaf that already carries a graph (the step differentiates a
        # loss built from these gradients) stays in it
        leaves = []
        for n in input_names:
            v = ctx._lookup(n)
            leaves.append(v if v.requires_grad
                          else v.detach().requires_grad_(True))
        env.update(zip(input_names, leaves))
        outer = ctx.trace
        trace = TraceContext(outer.program, outer.is_test, outer.device,
                             outer.step,
                             both_branches=outer.both_branches)
        for i, o in sliced:
            trace.current_op_idx = i
            try:
                get_op_impl(o.type)(OpContext(o, env, trace))
            except (EnforceNotMet, NotImplementedError):
                raise
            except Exception as e:
                raise wrap_op_error(e, o, i, env) from e
            outs = o.output_arg_names
            # the leaf wins over a producer of it: that cuts the graph
            for j, n in enumerate(input_names):
                if n in outs:
                    env[n] = leaves[j]
            for n in no_grad.intersection(outs):
                env[n] = env[n].detach()
        targets = [env[t] for t in target_names]
        seeds = [ctx._lookup(tg).to(t.dtype) if tg else torch.ones_like(t)
                 for t, tg in zip(targets, tg_names)]
        pairs = [(t, s) for t, s in zip(targets, seeds) if t.requires_grad]
        grads = [None] * len(leaves)
        if pairs:
            grads = torch.autograd.grad(
                [t for t, _ in pairs], leaves, [s for _, s in pairs],
                create_graph=True, allow_unused=True)
    ctx.set_outputs("InputGrads", [
        torch.zeros_like(v) if g is None else g
        for v, g in zip(leaves, grads)])
