# ported from paddle_tpu/core/interpreter.py
"""Block interpreter: runs a list of symbolic ops over a name→tensor env.

This is Fluid's executor hot loop (``framework/executor.cc:433``). The JAX
package runs it once per compilation inside ``jax.jit`` tracing; the port
runs it eagerly on every step, each op launching its torch kernels on the
env's device as it comes. Under ``torch.autograd`` the forward ops record
the graph the Executor differentiates.

Sub-blocks (``dynamic_rnn``) run through the same loop once a timestep,
at offset ``10_000 * block.idx``, with the step's trace; an error inside
one is enriched once, with the inner op. The JAX package runs them under
a ``PerStepTrace`` that folds the timestep into each op's threefry key,
so a stochastic op draws a fresh mask every timestep. Here the op's one
generator (keyed by its position in the sub-block, made on its first
draw and reseeded by the plan before each step) advances with every
draw, so each timestep takes the next masks of its stream, the same
eagerly and in a captured step, where the graph registers the
generator; no per-step trace is needed.

Left out against the JAX package: op-identity named scopes and the
numerics watchdog.
"""

from __future__ import annotations

from typing import Any, Dict

from .registry import OpContext, get_op_impl

# Ops that are markers/IO and never execute as kernels.
SKIP_OPS = frozenset({"backward_marker", "feed", "fetch"})


def run_block_ops(ops, env: Dict[str, Any], trace, offset: int = 0):
    from .enforce import EnforceNotMet, wrap_op_error

    for i, op in enumerate(ops):
        if op.type in SKIP_OPS:
            continue
        trace.current_op_idx = offset + i
        impl = get_op_impl(op.type)
        try:
            impl(OpContext(op, env, trace))
        except EnforceNotMet:
            raise  # already enriched (nested blocks)
        except NotImplementedError:
            raise  # registry gap message is already the good pattern
        except Exception as e:
            raise wrap_op_error(e, op, offset + i, env) from e
