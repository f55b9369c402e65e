# ported from paddle_tpu/executor.py
"""Executor: runs a Fluid ``Program`` eagerly on one device.

The JAX package traces a program once into a ``jax.jit``-compiled step
(``_CompiledStep``) and differentiates it with ``jax.value_and_grad``.
The port runs the same ops eagerly through the interpreter
(:func:`~.core.interpreter.run_block_ops`), one torch call after another:

* feeds become tensors on the executor's device, in their declared dtypes;
* with a ``backward_marker`` (``optimizer.minimize`` appended one), the
  ops before it run under autograd with each trainable parameter a leaf,
  the loss is ``sum(loss.float())``, and ``torch.autograd.grad`` binds each
  ``p@GRAD`` name of ``program._backward_info["param_to_grad"]``;
* the ops after the marker (regularizers, clipping, the optimizer's
  updates) run under ``torch.no_grad()``;
* every persistable var the step wrote goes back into the ``Scope``, and
  the fetches come back as numpy arrays (``return_numpy``) or tensors.

Stochastic ops draw from a ``torch.Generator`` per op, seeded from (seed
attr or ``program.random_seed``, step index, op position); the step index
counts the runs of each program (``_next_step_index``).

Left out against the JAX package: jit and ``CompiledProgram``, meshes,
gradient accumulation, sparse gradients, AMP, ``run_steps``, the numerics
watchdog, the trace-time optimizer passes and py_readers.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ops  # noqa: F401  (registers the ops)
from .core.dtypes import to_torch_dtype
from .core.framework import (Program, Variable, default_main_program,
                             grad_var_name)
from .core.interpreter import run_block_ops
from .core.place import resolve_device
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401

__all__ = ["Executor", "global_scope", "scope_guard"]

_SEED_MIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB)


def _mix_seed(seed: int, step: int, idx: int) -> int:
    """A 63-bit generator seed from (seed, step, op position): a splitmix
    style mix, so neighbouring steps and ops get unrelated streams."""
    h = 0
    for k, val in zip(_SEED_MIX, (seed, step, idx)):
        h = ((h ^ (val & 0xFFFFFFFFFFFFFFFF)) * k) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h & 0x7FFFFFFFFFFFFFFF


class TraceContext:
    """Per-run state handed to the ops: test mode, device, the step index
    and the op position that seed each stochastic op's generator."""

    def __init__(self, program: Program, is_test: bool, device: torch.device,
                 step: int):
        self.program = program
        self.is_test = is_test
        self.device = device
        self.step = int(step)
        self.current_op_idx = 0

    def op_rng(self, ctx) -> torch.Generator:
        seed = ctx.attr("seed", 0) or self.program.random_seed
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_mix_seed(int(seed), self.step, self.current_op_idx))
        return gen


class Executor:
    """reference: python/paddle/fluid/executor.py:262.

    ``Executor()`` and ``Executor(CUDAPlace(i))`` run on the card and raise
    ``RuntimeError`` where PyTorch sees no GPU; ``Executor(CPUPlace())``
    runs on the CPU."""

    def __init__(self, place=None):
        self.place = resolve_device(place)

    def close(self):
        """Parity with executor.py:388; the eager executor caches nothing."""

    # -- helpers --------------------------------------------------------------
    @staticmethod
    def _fetch_names(fetch_list) -> Tuple[str, ...]:
        names = []
        for f in fetch_list or []:
            names.append(f.name if isinstance(f, Variable) else str(f))
        return tuple(names)

    @staticmethod
    def _persistable_names(program: Program) -> Tuple[str, ...]:
        return tuple(sorted({v.name for v in program.list_vars()
                             if v.persistable}))

    @staticmethod
    def _next_step_index(program: Program) -> int:
        """The step index of this run; the counter lives on the Program so
        it dies with it."""
        step = getattr(program, "_tpu_step_counter", 0)
        program._tpu_step_counter = step + 1
        return step

    def _feed_tensor(self, block, name, value) -> torch.Tensor:
        """A feed as a tensor on the executor's device, in the dtype the
        program declares for it (the value's own dtype when undeclared)."""
        dtype = None
        if block.has_var(name):
            dtype = to_torch_dtype(block.var(name).dtype)
        if isinstance(value, torch.Tensor):
            return value.to(device=self.place, dtype=dtype)
        return torch.tensor(np.asarray(value)).to(device=self.place,
                                                  dtype=dtype)

    # -- the public API -------------------------------------------------------
    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence] = None,
        feed_var_name: str = "feed",
        fetch_var_name: str = "fetch",
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        use_program_cache: bool = True,
    ):
        """Run ``program`` once (one training step for a program with a
        backward marker). Returns the fetches, as numpy arrays when
        ``return_numpy``, else as tensors on the device.

        ``feed_var_name``, ``fetch_var_name`` and ``use_program_cache`` are
        Fluid's signature. The eager executor has no feed/fetch holder vars,
        so other names than the defaults raise; it builds nothing to cache,
        so both values of ``use_program_cache`` run alike."""
        from .core.framework import in_test_mode

        if (feed_var_name, fetch_var_name) != ("feed", "fetch"):
            raise ValueError(
                "feed_var_name/fetch_var_name other than 'feed'/'fetch' are "
                "not supported (got %r/%r)" % (feed_var_name, fetch_var_name))

        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        block = program.global_block
        fetch_names = self._fetch_names(fetch_list)
        feeds = {n: self._feed_tensor(block, n, v)
                 for n, v in (feed or {}).items()}
        state_names = self._persistable_names(program)
        state = {}
        for n in state_names:
            val = scope.find_var(n)
            if val is not None:
                if not isinstance(val, torch.Tensor):
                    val = torch.as_tensor(np.asarray(val))
                state[n] = val if val.device == self.place \
                    else val.to(self.place)

        trace = TraceContext(program, in_test_mode(), self.place,
                             self._next_step_index(program))
        ops = block.ops
        bw = program._backward_info
        marker_idx = next((i for i, op in enumerate(ops)
                           if op.type == "backward_marker"), None)
        if bw is None or marker_idx is None:
            env = dict(state)
            env.update(feeds)
            with torch.no_grad():
                run_block_ops(ops, env, trace)
        else:
            env = self._train_step(ops, marker_idx, bw, state, feeds, trace,
                                   fetch_names)

        for n in state_names:
            val = env.get(n)
            if val is not None:
                scope.set_var(n, val.detach())
        missing = [f for f in fetch_names if f not in env]
        if missing:
            raise KeyError("fetch of %s: not computed by the program and not "
                           "in the scope" % missing)
        fetches = [env[f].detach() for f in fetch_names]
        if return_numpy:
            return [_to_numpy(t) for t in fetches]
        return fetches

    @staticmethod
    def _train_step(ops, marker_idx, bw, state, feeds, trace, fetch_names):
        """Forward under autograd, ``torch.autograd.grad`` into the
        ``p@GRAD`` names, then the post-marker ops under ``no_grad``. The
        forward's activations leave the env once the gradients exist,
        unless a fetch or a post-marker op reads them."""
        loss_name = bw["loss"]
        param_to_grad = bw["param_to_grad"]
        param_names = [p for p in param_to_grad if p in state]
        leaves = {n: state[n].detach().requires_grad_(True)
                  for n in param_names}
        env = dict(state)
        env.update(leaves)
        env.update(feeds)
        with torch.enable_grad():
            run_block_ops(ops[:marker_idx], env, trace)
            loss = torch.sum(env[loss_name].float())
            grads = torch.autograd.grad(
                loss, [leaves[n] for n in param_names], allow_unused=True)
        post_ops = ops[marker_idx + 1:]
        keep = set(state) | set(fetch_names) | {
            n for op in post_ops for n in op.input_arg_names}
        env = {n: v for n, v in env.items() if n in keep}
        env.update({n: state[n] for n in param_names})
        for n, g in zip(param_names, grads):
            env[param_to_grad[n]] = torch.zeros_like(state[n]) if g is None \
                else g
        env[bw.get("loss_grad") or grad_var_name(loss_name)] = \
            torch.ones_like(loss)
        with torch.no_grad():
            run_block_ops(post_ops, env, trace,
                          offset=marker_idx + 1)
        return env


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
