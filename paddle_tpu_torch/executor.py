# ported from paddle_tpu/executor.py
"""Executor: runs a Fluid ``Program`` on one device, eagerly or as a
captured step.

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
* a parameter marked ``is_sparse_param`` (an ``is_sparse`` embedding
  table) is no leaf: its lookup adds a zero "virtual rows" leaf [N, D] to
  the rows it gathers and registers it in ``trace.sparse_rows``, and
  ``p@GRAD`` becomes ``core.sparse.SparseGrad(ids, rows)``, the leaf's
  [N, D] gradient, so no [V, D] gradient exists;
* every persistable var the step wrote goes back into the ``Scope``, and
  the fetches come back as numpy arrays (``return_numpy``) or tensors.

Mixed precision (:mod:`.amp` sets ``program._amp_dtype``): the float32
parameters and feeds are cast to that dtype for the forward, inside the
autograd graph, so the gradients arrive in float32 on the float32 master
weights, which the optimizer ops read and update. The loss is summed in
float32. A run without a backward casts a copy of its inputs and writes
back only what an op rewrote, in the dtype the scope held.

Stochastic ops draw from one ``torch.Generator`` per op position, made
once per plan (:class:`_Plan`) and seeded before every step from (seed
attr or ``program.random_seed``, step index, op position); the step index
counts the steps of each program (``_next_step_index``). The op position
is the ``__rng_slot__`` the pass pipeline stamps before it rewrites, so a
pass that deletes or moves ops leaves every stream where it was.

Before a program runs, the default pass pipeline (:mod:`.passes`,
``PADDLE_TPU_OPT_LEVEL``, default 1) rewrites a memoized clone of it for
the run's fetch set (:meth:`Executor._maybe_optimize`): dead ops go,
constant chains fold, duplicates merge, ``softmax`` + ``cross_entropy``
becomes the fused loss and the unfused attention composition the fused
attention op. The plans and captured steps are made from that clone; the
step counter stays on the source program.

Gradient accumulation (``BuildStrategy.gradient_accumulation_steps``, a
``CompiledProgram`` through ``run`` or ``run_steps``): every feed is split
along dim 0 into that many microbatches, each runs the forward and its
``torch.autograd.grad`` from the step's state, the gradients are summed
and divided by the count, and the post-marker ops run once, on the last
microbatch's env with the mean of the microbatch losses.

The captured step (:class:`_CapturedStep`) is the counterpart of the JAX
package's one compiled dispatch: ``Executor.run(CompiledProgram)`` and
:meth:`Executor.run_steps` warm a step up eagerly, capture the same step
body once into a ``torch.cuda.CUDAGraph`` for each feed signature, and
replay it. The scope's tensors are the graph's static state, which the
body updates with ``copy_``. On the CPU the same calls run the body step
by step, without a graph. What the JAX package compiles as control flow
is captured too: a ``conditional_block`` runs both branches and selects
on the device (``lax.cond``), and a forward program's ``while`` loops
become graphs of their own, one replayed once an iteration after a host
read of the condition, between graphs of the ops before and after them.
:meth:`Executor.prepare` warms a step up on copies and captures it before
its first run; :meth:`Executor.memory_report` reads the prepared step's
memory.

Programs with started py_readers (``layers.py_reader``) are fed from
them, as in the JAX package: ``run`` takes one batch from each started
reader whose vars the feed does not cover, and ``run_steps`` without a
``feed_iter`` drains them until one raises ``EOFException``. A
``DevicePrefetcher`` (``reader/prefetcher.py``) that ``run_steps`` starts
is its own, and stopped when it returns; its feeds arrive on the device,
and the captured step copies them into its static feeds on the device.
While a step is captured no prefetcher issues CUDA work
(``reader.prefetcher.CAPTURE_LOCK``).

Left out against the JAX package: meshes, the numerics watchdog, the
flight recorder, fault injection and the metrics histograms.
"""

from __future__ import annotations

import time
import warnings
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ops  # noqa: F401  (registers the ops)
from .ops import control_flow_ops as _cf
from .core.dtypes import to_torch_dtype
from .core.framework import (Program, Variable, default_main_program,
                             grad_var_name, in_test_mode)
from .core.interpreter import run_block_ops
from .core.place import resolve_device
from .core.sparse import SparseGrad
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401
from .monitor import metrics
from .reader.prefetcher import CAPTURE_LOCK, DevicePrefetcher
from .reader.py_reader import EOFException
from .serving.captured import end_failed_capture, gc_paused

__all__ = ["Executor", "FeedError", "FetchHandle", "global_scope",
           "scope_guard"]

_SEED_MIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB)

# eager steps of a captured step before its capture: they resolve cuDNN's
# algorithm search, cuBLAS's workspaces and the kernels' library loads
WARMUP_STEPS = 2

# ops that need the host while a step runs: ``print`` and ``py_func`` run
# Python on a host copy, ``tree_conv`` builds its patch matrices from a
# host copy of its edges, ``detection_map`` matches detections to boxes on
# the host (``metrics.DetectionMAP``). A CUDA graph replays none of them, so a captured
# step whose program holds one (in any block) runs every step eagerly on
# its device instead, counted by ``Executor.host_op_steps``. So does a
# ``while`` the captured step cannot split the step at: one inside another
# block, or in a program that trains (no model of either package trains
# through a ``while``: its gradient raises)
HOST_OPS = frozenset({"print", "py_func", "tree_conv", "detection_map"})

# ops that index by their data: run untaken in a captured
# ``conditional_block`` they may see an index out of range, a device
# assert on the card, so a branch holding one keeps the step eager
INDEXING_OPS = frozenset({"gather", "gather_nd", "scatter",
                          "sequence_scatter", "one_hot", "lookup_table",
                          "fused_embedding_seq_pool", "unpool", "psroi_pool",
                          "sample_logits"})


def _mix_seed(seed: int, step: int, idx: int) -> int:
    """A 63-bit generator seed from (seed, step, op position): a splitmix
    style mix, so neighbouring steps and ops get unrelated streams."""
    h = 0
    for k, val in zip(_SEED_MIX, (seed, step, idx)):
        h = ((h ^ (val & 0xFFFFFFFFFFFFFFFF)) * k) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h & 0x7FFFFFFFFFFFFFFF


class FeedError(RuntimeError):
    """The feed source raised while ``run_steps`` assembled a chunk; the
    message names the global step and its position in the chunk."""


class TraceContext:
    """Per-run state handed to the ops: test mode, device, the step index
    and the op position that seed each stochastic op's generator, and in a
    training step the names of its sparse tables (``sparse_params``) with
    the (ids, virtual rows leaf) their lookups register (``sparse_rows``).
    ``generators`` ({op position: (generator, op)}) is the plan's; a
    context without one makes its own. ``both_branches`` (the captured
    step) makes a ``conditional_block`` run both branches and select on
    the device."""

    def __init__(self, program: Program, is_test: bool, device: torch.device,
                 step: int, generators: Optional[dict] = None,
                 both_branches: bool = False):
        self.program = program
        self.both_branches = both_branches
        self.is_test = is_test
        self.device = device
        self.step = int(step)
        self.current_op_idx = 0
        self.sparse_params = frozenset()
        self.sparse_rows = {}
        self.generators = {} if generators is None else generators

    def op_rng(self, ctx) -> torch.Generator:
        """The generator of the running op, keyed by its ``__rng_slot__``
        (its position in the source program, stamped by the pass pipeline)
        or else its position ``current_op_idx``; made on its first draw and
        seeded for this step, then reseeded by the plan before later steps
        (:meth:`_Plan.reseed`)."""
        idx = ctx.attr("__rng_slot__")
        if idx is None:
            idx = self.current_op_idx
        entry = self.generators.get(idx)
        if entry is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(_op_seed(self.program, ctx.op, self.step, idx))
            entry = self.generators[idx] = (gen, ctx.op)
        return entry[0]


def _op_seed(program, op, step, idx) -> int:
    seed = op.attrs.get("seed", 0) or program.random_seed
    return _mix_seed(int(seed), step, idx)


class _Plan:
    """What a program's step needs beside its state and feeds, resolved
    once for each (program, version, test mode, device): the op list and
    its backward marker, the AMP dtype, the persistable names, and one
    generator per stochastic op slot."""

    def __init__(self, program: Program, is_test: bool):
        self.program_ref = weakref.ref(program)
        self.is_test = is_test
        self.ops = program.global_block.ops
        self.bw = program._backward_info
        self.marker_idx = next((i for i, op in enumerate(self.ops)
                                if op.type == "backward_marker"), None)
        amp_dtype = getattr(program, "_amp_dtype", None)
        self.amp_dtype = None if amp_dtype is None \
            else to_torch_dtype(amp_dtype)
        self.state_names = tuple(sorted({v.name for v in program.list_vars()
                                         if v.persistable}))
        self.generators: Dict[int, Tuple[torch.Generator, Any]] = {}

    def reseed(self, program: Program, step: int):
        """Seed every generator for ``step``: ``manual_seed`` also resets
        its offset, so each step draws what a fresh generator would."""
        for idx, (gen, op) in self.generators.items():
            gen.manual_seed(_op_seed(program, op, step, idx))


class _Fetched(torch.Tensor):
    """A fetched tensor that numpy reads: ``np.asarray`` waits for the
    card and copies it to the host, as it does a JAX array."""

    def __array__(self, dtype=None, copy=None):
        out = _to_numpy(self.as_subclass(torch.Tensor))
        return out if dtype is None else out.astype(dtype, copy=False)


class FetchHandle:
    """A chunk's fetches, as ``run_steps(..., return_numpy=False)`` returns
    them: tensors on the executor's device and, on the card, a CUDA event
    recorded after the chunk's last step. A chunk of n > 1 steps holds each
    fetch stacked on a leading axis of n.

    Indexing and iteration hand back the device tensors without a sync
    (``np.asarray`` of one waits and copies); :meth:`numpy` waits and copies
    them all."""

    __slots__ = ("_values", "_names", "_event", "_np")

    def __init__(self, values, names, event=None):
        self._values = list(values)
        self._names = tuple(names)
        self._event = event
        self._np = None

    @property
    def names(self):
        return self._names

    @property
    def raw(self):
        """The fetched tensors, no sync."""
        return list(self._values)

    def __len__(self):
        return len(self._values)

    def __getitem__(self, i):
        return self._values[i].as_subclass(_Fetched)

    def __iter__(self):
        return (v.as_subclass(_Fetched) for v in self._values)

    def done(self) -> bool:
        """True once the chunk's device work finished (no wait)."""
        return self._event is None or self._event.query()

    def block(self):
        """Wait for the chunk's device work; returns self."""
        if self._event is not None:
            self._event.synchronize()
        return self

    def numpy(self):
        """The fetches as host numpy arrays (waits; cached)."""
        if self._np is None:
            self.block()
            self._np = [_to_numpy(v) for v in self._values]
        return list(self._np)

    resolve = numpy


class Executor:
    """reference: python/paddle/fluid/executor.py:262.

    ``Executor()`` and ``Executor(CUDAPlace(i))`` run on the card and raise
    ``RuntimeError`` where PyTorch sees no GPU; ``Executor(CPUPlace())``
    runs on the CPU."""

    def __init__(self, place=None):
        self.place = resolve_device(place)
        self._plans: Dict[tuple, _Plan] = {}
        self._captured: Dict[tuple, "_CapturedStep"] = {}
        self._side_stream = None
        # steps that CompiledProgram/run_steps ran eagerly because their
        # program holds a host op (HOST_OPS)
        self.host_op_steps = 0

    def close(self):
        """Drop every plan and captured step, and with each CUDA graph its
        memory pool (reference: executor.py:388)."""
        for cap in self._captured.values():
            cap.release()
        self._captured.clear()
        self._plans.clear()

    # -- helpers --------------------------------------------------------------
    @staticmethod
    def _fetch_names(fetch_list) -> Tuple[str, ...]:
        names = []
        for f in fetch_list or []:
            names.append(f.name if isinstance(f, Variable) else str(f))
        return tuple(names)

    @staticmethod
    def _maybe_optimize(program: Program, fetch_names, scope) -> Program:
        """The default pass pipeline's memoized clone of ``program`` for
        this fetch set (``passes.pipeline.maybe_optimize``;
        ``PADDLE_TPU_OPT_LEVEL=0`` returns ``program`` itself). Plans and
        captured steps are made from the clone; callers keep the source for
        ``_next_step_index``, so the step counter, and with it every dropout
        stream, is shared by all fetch sets as at level 0."""
        from .passes.pipeline import maybe_optimize

        return maybe_optimize(program, fetch_names, scope)

    @staticmethod
    def _next_step_index(program: Program, n: int = 1) -> int:
        """The step index of this run (of the first of ``n`` steps); the
        counter lives on the Program so it dies with it."""
        step = getattr(program, "_tpu_step_counter", 0)
        program._tpu_step_counter = step + n
        return step

    def _feed_tensor(self, block, name, value) -> torch.Tensor:
        """A feed as a tensor on the executor's device, in the dtype the
        program declares for it (the value's own dtype when undeclared)."""
        dtype = _feed_dtype(block, name)
        if isinstance(value, torch.Tensor):
            return value.to(device=self.place, dtype=dtype)
        return torch.tensor(np.asarray(value)).to(device=self.place,
                                                  dtype=dtype)

    def _plan(self, program: Program) -> _Plan:
        is_test = in_test_mode()
        key = (id(program), program._version, is_test,
               getattr(program, "_amp_dtype", None))
        plan = self._plans.get(key)
        if plan is None or plan.program_ref() is not program:
            plan = self._plans[key] = _Plan(program, is_test)
        return plan

    def _gather_state(self, plan: _Plan, scope: Scope) -> Dict[str, Any]:
        state = {}
        for n in plan.state_names:
            val = scope.find_var(n)
            if val is not None:
                if not isinstance(val, torch.Tensor):
                    val = torch.as_tensor(np.asarray(val))
                state[n] = val if val.device == self.place \
                    else val.to(self.place)
        return state

    def _stream(self):
        """The side stream that warm-up steps and captures run on."""
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.place)
        return self._side_stream

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

        A ``CompiledProgram`` takes the captured step (its ``_run``); a
        ``Program`` runs eagerly.

        ``feed_var_name``, ``fetch_var_name`` and ``use_program_cache`` are
        Fluid's signature. The executor has no feed/fetch holder vars, so
        other names than the defaults raise; both values of
        ``use_program_cache`` run alike."""
        from .compiler import CompiledProgram

        if (feed_var_name, fetch_var_name) != ("feed", "fetch"):
            raise ValueError(
                "feed_var_name/fetch_var_name other than 'feed'/'fetch' are "
                "not supported (got %r/%r)" % (feed_var_name, fetch_var_name))
        if program is None:
            program = default_main_program()
        compiled = isinstance(program, CompiledProgram)
        feed = _drain_one_batch(program._program if compiled else program,
                                feed)
        if compiled:
            return program._run(self, feed=feed, fetch_list=fetch_list,
                                scope=scope, return_numpy=return_numpy)
        if scope is None:
            scope = global_scope()
        fetch_names = self._fetch_names(fetch_list)
        step = self._next_step_index(program)
        program = self._maybe_optimize(program, fetch_names, scope)
        block = program.global_block
        feeds = {n: self._feed_tensor(block, n, v)
                 for n, v in (feed or {}).items()}
        env = self._eager_step(program, self._plan(program), scope, feeds,
                               fetch_names, step)
        fetches = _fetches(env, fetch_names)
        if return_numpy:
            return [_to_numpy(t) for t in fetches]
        return fetches

    def infer_from_program(self, *args, **kwargs):
        """Fluid's alias of :meth:`run` (reference: executor.py:1779)."""
        return self.run(*args, **kwargs)

    def run_steps(
        self,
        program: Optional[Program] = None,
        feed_iter=None,
        steps: Optional[int] = None,
        fetch_list: Optional[Sequence] = None,
        fetch_every: int = 1,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ):
        """Drive up to ``steps`` training steps from ``feed_iter`` (one
        feed dict a step) through the captured step, ``fetch_every`` steps
        to a chunk: on the card the chunk's steps are graph replays issued
        back to back with no host sync between them, and its fetches are
        copied into [n, ...] tensors, one host copy a chunk. A
        ``CompiledProgram`` is unwrapped to its program.

        ``steps=None`` runs until the feeds are exhausted. A feed-shape
        change (the final partial batch of an epoch) cuts the chunk and
        resolves another captured step for the new shapes. A feed source
        that raises surfaces as :class:`FeedError`.

        ``feed_iter=None`` drains the program's started py_readers until
        one raises ``EOFException`` (``ValueError`` when none is started).
        A :class:`~.reader.DevicePrefetcher` that is not started yet is
        started here and stopped on return, also on an early return at
        ``steps``; one the caller started stays the caller's to stop.

        Returns per-step fetch rows (``return_numpy=True``: a list of
        ``[np.ndarray, ...]``, equal to ``steps`` individual ``run()``
        calls from the same start) or one :class:`FetchHandle` per chunk
        (``return_numpy=False``; a chunk of n > 1 steps resolves to arrays
        with a leading axis of n, a single-step chunk's to per-fetch
        arrays like ``run()``'s)."""
        if scope is None:
            scope = global_scope()
        src, accum = self._unwrap_program(program, scope)
        owned = None
        if feed_iter is None:
            feed_iter = _drain_readers(src)
        elif isinstance(feed_iter, DevicePrefetcher) \
                and feed_iter._thread is None:
            owned = feed_iter
        try:
            return self._run_steps(src, accum, iter(feed_iter), steps,
                                   fetch_list, fetch_every, scope,
                                   return_numpy)
        finally:
            if owned is not None:
                owned.stop()

    def _run_steps(self, src, accum, feed_iter, steps, fetch_list,
                   fetch_every, scope, return_numpy):
        fetch_names = self._fetch_names(fetch_list)
        program = self._maybe_optimize(src, fetch_names, scope)
        k = max(1, int(fetch_every))
        rows: List[Any] = []
        handles: List[FetchHandle] = []
        consumed = 0
        pending = None  # the feed that cut the previous chunk
        while steps is None or consumed < steps:
            want = k if steps is None else min(k, steps - consumed)
            chunk, sig0 = [], None
            while len(chunk) < want:
                if pending is not None:
                    f, pending = pending, None
                else:
                    try:
                        f = next(feed_iter)
                    except StopIteration:
                        break
                    except Exception as e:
                        raise FeedError(
                            "run_steps(): feed source raised at global step "
                            "%d (position %d of the current %d-step chunk): "
                            "%s: %s" % (consumed + len(chunk), len(chunk),
                                        want, type(e).__name__, e)) from e
                try:
                    sig, f = _feed_signature(f)
                except Exception as e:
                    raise FeedError(
                        "run_steps(): feed for global step %d (position %d "
                        "of the current %d-step chunk) could not be "
                        "converted to arrays: %s: %s"
                        % (consumed + len(chunk), len(chunk), want,
                           type(e).__name__, e)) from e
                if chunk and sig != sig0:
                    pending = f
                    break
                sig0 = sig
                chunk.append(f)
            if not chunk:
                break
            cap = self._captured_step(program, scope, sig0, fetch_names,
                                      accum)
            n = len(chunk)
            step0 = self._next_step_index(src, n)
            bufs = None
            for i, f in enumerate(chunk):
                outs = cap.step(f, step0 + i)
                if n == 1:
                    bufs = [o.clone() for o in outs]
                    continue
                if bufs is None:
                    bufs = [o.new_empty((n,) + tuple(o.shape)) for o in outs]
                for b, o in zip(bufs, outs):
                    b[i].copy_(o)
            consumed += n
            if not fetch_names:
                continue
            event = None
            if self.place.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.place))
            handle = FetchHandle(bufs, fetch_names, event)
            if not return_numpy:
                handles.append(handle)
            elif n == 1:
                rows.append(handle.numpy())
            else:
                arrs = handle.numpy()
                rows.extend([a[i] for a in arrs] for i in range(n))
        if not fetch_names:
            return []
        return rows if return_numpy else handles

    def prepare(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
    ):
        """Build and capture the step for ``feed`` ahead of its first run
        (reference: the JAX package's ``Executor.prepare``, which compiles
        it ahead of time). ``feed`` values may be arrays or ``(shape,
        dtype)`` tuples; only their shapes and dtypes matter. Accepts a
        ``CompiledProgram`` like ``run()``. The warm-up steps run on copies
        of the scope's state (and on zeros for an abstract feed), so the
        scope and the step counter stay as they were: ``prepare`` and then
        N runs give the bits of N runs, and the first of them replays.
        Returns the captured step (``_CapturedStep``), the one a later
        ``run(CompiledProgram)`` or ``run_steps`` at the same feed shapes,
        fetches and scope takes."""
        if scope is None:
            scope = global_scope()
        src, accum = self._unwrap_program(program, scope)
        fetch_names = self._fetch_names(fetch_list)
        prog = self._maybe_optimize(src, fetch_names, scope)
        sig, arrays = _feed_signature(_concrete_feed(feed or {}))
        cap = self._captured_step(prog, scope, sig, fetch_names, accum)
        cap.prepare(prog, scope, arrays,
                    getattr(src, "_tpu_step_counter", 0))
        return cap

    def memory_report(self, program=None, feed=None, fetch_list=None,
                      scope=None) -> Dict[str, float]:
        """The memory of the step :meth:`prepare` builds for ``feed``
        (arrays or ``(shape, dtype)`` tuples), with the JAX package's keys
        (``paddle_tpu/monitor/device.py``): on the card ``argument_bytes``
        (the static state and feeds), ``output_bytes`` (the fetches and the
        state written), ``temp_bytes`` (what the graphs' memory pools hold
        beyond the fetches in them), ``alias_bytes`` (outputs written into
        their arguments), ``generated_code_bytes`` (0: a CUDA graph
        replays kernels already loaded) and ``peak_hbm_bytes``. The CPU
        has no graph: the pools' keys and the peak are left out, as the
        JAX package leaves out what its backend lacks. Run the startup
        program first, so the parameters are part of the figure."""
        return self.prepare(program, feed, fetch_list, scope).memory_report()

    @staticmethod
    def _unwrap_program(program, scope):
        """(plain program, gradient accumulation steps) of a possibly
        wrapped ``CompiledProgram`` (reference: executor.py:870), after its
        strategy checks and its build passes."""
        from .compiler import CompiledProgram

        accum = 1
        if isinstance(program, CompiledProgram):
            program, accum = program._checked_program(scope)
        return (default_main_program() if program is None else program,
                accum)

    def _captured_step(self, program, scope, sig, fetch_names, accum=1):
        """The captured step of (program, version, feed signature, fetch
        names, test mode, AMP dtype, scope, accumulation steps); made on
        first use."""
        plan = self._plan(program)
        key = (id(program), program._version, sig, fetch_names,
               plan.is_test, getattr(program, "_amp_dtype", None), id(scope),
               accum)
        cap = self._captured.get(key)
        if cap is None or cap.plan is not plan or cap.scope_ref() is not scope:
            if cap is not None:
                cap.release()
            cap = self._captured[key] = _CapturedStep(
                self, program, plan, scope, sig, fetch_names, accum)
        return cap

    # -- the step body --------------------------------------------------------
    def _eager_step(self, program, plan, scope, feeds, fetch_names, step,
                    accum=1, both_branches=False):
        """One eager step: the body on the scope's state, then every
        persistable it computed set into the scope. Returns the env."""
        state = self._gather_state(plan, scope)
        plan.reseed(program, step)
        trace = TraceContext(program, plan.is_test, self.place, step,
                             plan.generators, both_branches)
        env = self._body(plan, state, feeds, fetch_names, trace, accum)
        for n in plan.state_names:
            val = env.get(n)
            if val is not None:
                scope.set_var(n, val.detach())
        return env

    def _body(self, plan: _Plan, state, feeds, fetch_names, trace, accum=1):
        """The step: ``(state, feeds, step) -> env`` of every var it
        computed (state writes and fetches among them). The same function
        runs eagerly and under capture; it reads the host for nothing.
        ``accum`` > 1 splits a training step into that many microbatches
        (:meth:`_train_step`); a program without a backward ignores it."""
        if plan.bw is None or plan.marker_idx is None:
            env, before = _forward_env(plan, state, feeds)
            with torch.no_grad():
                run_block_ops(plan.ops, env, trace)
            _forward_done(plan, state, env, before)
            return env
        return self._train_step(plan.ops, plan.marker_idx, plan.bw, state,
                                feeds, trace, fetch_names, plan.amp_dtype,
                                accum)

    @staticmethod
    def _train_step(ops, marker_idx, bw, state, feeds, trace, fetch_names,
                    amp_dtype=None, accum=1):
        """Forward under autograd, ``torch.autograd.grad`` into the
        ``p@GRAD`` names, then the post-marker ops under ``no_grad``. The
        forward's activations leave the env once the gradients exist,
        unless a fetch or a post-marker op reads them. With ``amp_dtype``
        the forward reads casts of the float32 leaves and feeds; the cast
        is part of the graph, so each gradient is float32.

        With ``accum`` > 1 (gradient accumulation, JAX package
        ``executor.py:603-652``) each feed splits along dim 0 into ``accum``
        microbatches; each runs the forward from the step's state and its
        own ``autograd.grad``, so one microbatch's activations live at a
        time. The gradients are summed in microbatch order and divided by
        ``accum``, the loss is the mean of the microbatch losses, and the
        post-marker ops read the last microbatch's env (its batch-norm
        statistics and non-loss fetches), as in the JAX package."""
        loss_name = bw["loss"]
        param_to_grad = bw["param_to_grad"]
        block = trace.program.global_block
        sparse_names = [p for p in param_to_grad if p in state and getattr(
            block._find_var_recursive(p), "is_sparse_param", False)]
        param_names = [p for p in param_to_grad
                       if p in state and p not in sparse_names]
        if accum > 1 and sparse_names:
            raise NotImplementedError(
                "is_sparse embeddings + gradient accumulation is not "
                "supported (per-microbatch row shapes), as in the JAX "
                "package: %s" % sparse_names)
        leaves = {n: state[n].detach().requires_grad_(True)
                  for n in param_names}
        trace.sparse_params = frozenset(sparse_names)
        grads, loss_sum = None, None
        for sub in _microbatches(feeds, accum):
            env = dict(state)
            with torch.enable_grad():
                env.update(_amp_cast(leaves, amp_dtype))
                env.update(_amp_cast(sub, amp_dtype))
                run_block_ops(ops[:marker_idx], env, trace)
                missing = [p for p in sparse_names
                           if p not in trace.sparse_rows]
                if missing:
                    raise ValueError("params marked is_sparse but never "
                                     "looked up sparsely: %s" % missing)
                virtuals = [trace.sparse_rows[p][1] for p in sparse_names]
                loss = torch.sum(env[loss_name].float())
                g_i = torch.autograd.grad(
                    loss, [leaves[n] for n in param_names] + virtuals,
                    allow_unused=True)
            if grads is None:
                grads, loss_sum = list(g_i), loss.detach()
                continue
            loss_sum = loss_sum + loss.detach()
            for i, g in enumerate(g_i):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
        if accum > 1:
            grads = [None if g is None else g / accum for g in grads]
            env[loss_name] = loss_sum / accum
        post_ops = ops[marker_idx + 1:]
        keep = set(state) | set(fetch_names) | {
            n for op in post_ops for n in op.input_arg_names}
        env = {n: v for n, v in env.items() if n in keep}
        env.update({n: state[n] for n in param_names})
        for n, g in zip(param_names, grads):
            env[param_to_grad[n]] = torch.zeros_like(state[n]) if g is None \
                else g
        for n, g in zip(sparse_names, grads[len(param_names):]):
            ids, virt = trace.sparse_rows[n]
            env[param_to_grad[n]] = SparseGrad(
                ids, torch.zeros_like(virt) if g is None else g)
        env[bw.get("loss_grad") or grad_var_name(loss_name)] = \
            torch.ones_like(loss)
        with torch.no_grad():
            run_block_ops(post_ops, env, trace,
                          offset=marker_idx + 1)
        return env


class _CapturedStep:
    """One program's step at one feed signature (and gradient accumulation
    count), the counterpart of the JAX package's
    ``_CompiledStep``/``_DispatchPlan`` (``paddle_tpu/executor.py:442,
    787``); an accumulated step is one graph holding all its
    microbatches.

    Its first ``WARMUP_STEPS`` steps run eagerly (on a side stream on the
    card); they are real steps with their own step indexes
    (:meth:`prepare` runs them on copies instead, before the first step).
    Then the scope's persistable tensors become the static state, the
    feeds get static buffers, and on the card the body is captured once
    into a ``torch.cuda.CUDAGraph``, its generators registered with the
    graph (capture executes nothing: the first replay runs the step
    captured). Each later step reseeds the generators, brings back into the
    static state any var an eager ``run()`` replaced in the scope, fills
    the static feeds and replays the graph; on the CPU it runs the body. A
    capture that fails raises, naming the op; nothing runs eagerly in its
    place. The warm-ups, the capture and the body run every
    ``conditional_block`` with both branches (``TraceContext.both_branches``).

    A forward program whose global block holds ``while`` ops is split at
    them (:attr:`pieces`): each run of ops between loops is a graph, and
    each loop's body another, keyed by the loop and its carry's shapes,
    each graph in a memory pool of its own (graphs sharing one pool broke
    a later cuBLAS capture on the H100: ``serving/captured.py``). The run
    before a loop ends by copying the carry into static tensors; the body
    reads them and writes the next iteration's carry back into them
    (``control_flow_ops.write_carry``); a step replays the graph of each
    run and, for each loop, reads the condition on the host and replays
    the body while it holds.

    A program that holds a host op (:data:`HOST_OPS`, in any block), a
    ``while`` outside the global block or a ``while`` beside backward ops
    is never captured: each of its steps runs eagerly on the executor's
    device, as ``Executor.run`` would run it, adds one to
    ``Executor.host_op_steps``, and the first one warns, naming the op,
    its block and its index. So does one whose ``conditional_block``
    branch holds an op of :data:`INDEXING_OPS`."""

    def __init__(self, exe: Executor, program, plan, scope, sig, fetch_names,
                 accum=1):
        # the first op that keeps the step eager, as (type, block, index,
        # why), or None
        self.host_op = _eager_reason(program, plan)
        self.exe = exe
        self.program_ref = weakref.ref(program)
        self.plan = plan
        self.scope_ref = weakref.ref(scope)
        self.sig = sig
        self.fetch_names = fetch_names
        self.accum = accum
        self.warm_left = WARMUP_STEPS
        self.state: Optional[Dict[str, torch.Tensor]] = None
        self.feeds: Dict[str, torch.Tensor] = {}
        self.outputs: List[torch.Tensor] = []
        self.graph = None
        # (start, end, while op or None) of each run of global-block ops
        # and the loop after it, for a forward program with a ``while``
        self.pieces = _pieces(plan) if self.host_op is None else None
        # the replay plan of a split step: ("ops", graph or None) and
        # ("loop", condition name, body graph), in order, and the pieces'
        # state ({"env": the static tensors the graphs read and write})
        self.replays: List[tuple] = []
        self.box: Dict[str, Any] = {}
        self.graphs = 0
        self.pool_bytes = 0
        self.capture_s = 0.0
        self.warm_shapes: List[tuple] = []

    def release(self):
        """Drop the graphs (and with them their memory pools) and the static
        buffers."""
        for g in [self.graph] + [r[-1] for r in self.replays]:
            if g is not None:
                g.reset()
        self.graph = None
        self.replays, self.box = [], {}
        self.state = None
        self.feeds = {}
        self.outputs = []

    def step(self, feed, step: int) -> List[torch.Tensor]:
        """Run one step on ``feed``; returns its fetches, which the caller
        copies before the next step (static outputs on the card)."""
        exe, program, scope = self.exe, self.program_ref(), self.scope_ref()
        if self.host_op is not None:
            return self._host_op_step(program, scope, feed, step)
        if self.warm_left > 0:
            self.warm_left -= 1
            return self._warm_step(program, scope, feed, step)
        if self.state is None:
            self._capture(program, scope, step)
        self._restore_state(scope)
        for n, v in feed.items():
            src = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))
            self.feeds[n].copy_(src, non_blocking=True)
        self.plan.reseed(program, step)
        if exe.place.type != "cuda":
            self.outputs = self._static_body(program, step)
        elif self.pieces is None:
            self.graph.replay()
            metrics.REPLAYS.inc()
        else:
            self._replay_pieces()
        return self.outputs

    def _warm_step(self, program, scope, feed, step):
        """One eager warm-up step on ``scope`` (a real one, or
        :meth:`prepare`'s copies), on a side stream on the card."""
        exe = self.exe
        block = program.global_block
        feeds = {n: exe._feed_tensor(block, n, v) for n, v in feed.items()}

        def run():
            env = exe._eager_step(program, self.plan, scope, feeds,
                                  self.fetch_names, step, self.accum,
                                  both_branches=True)
            return _fetches(env, self.fetch_names)

        if exe.place.type != "cuda":
            outs = run()
        else:
            cur = torch.cuda.current_stream(exe.place)
            side = exe._stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                outs = run()
            cur.wait_stream(side)
        self.warm_shapes = [(tuple(o.shape), o.dtype) for o in outs]
        return outs

    def prepare(self, program, scope, feed, step):
        """The warm-ups on copies of the scope's state and on ``feed`` (the
        caller's arrays, or zeros for an abstract feed), then, on the card,
        the capture against the scope's own tensors: the scope, its values
        and the program's step counter stay as they were, and the next
        step replays."""
        if self.host_op is not None:
            return
        while self.warm_left > 0:
            self.warm_left -= 1
            throwaway = Scope()
            for n in self.plan.state_names:
                val = scope.find_var(n)
                if val is not None:
                    throwaway.set_var(n, val.clone() if isinstance(
                        val, torch.Tensor) else np.array(val))
            self._warm_step(program, throwaway, feed, step)
        if self.state is None:
            self._capture(program, scope, step)

    def memory_report(self) -> Dict[str, float]:
        """The JAX package's ``memory_analysis`` keys for this step: the
        static state and feeds (``argument_bytes``), the fetches and the
        state the step writes (``output_bytes``), the state written in
        place and the fetches that are arguments (``alias_bytes``); on the
        card also the bytes the graphs' memory pools hold beyond the
        fetches that live in them (``temp_bytes``), no generated code (a
        graph replays kernels already loaded) and ``peak_hbm_bytes``
        (arguments + outputs + temporaries - aliases). A step kept eager
        has no static buffers and reports nothing."""
        if self.state is None:
            return {}
        args = {id(t): t for t in list(self.state.values())
                + list(self.feeds.values())}
        arg_bytes = sum(_nbytes(t) for t in args.values())
        written = sum(_nbytes(t) for n, t in self.state.items()
                      if n in self._written)
        if self.outputs:
            fetched = [(_nbytes(o), _is_argument(o, args))
                       for o in self.outputs]
        else:
            fetched = [(int(np.prod(shape)) * dt.itemsize, False)
                       for shape, dt in self.warm_shapes]
        out_bytes = written + sum(b for b, _ in fetched)
        alias = written + sum(b for b, arg in fetched if arg)
        out = {"argument_bytes": float(arg_bytes),
               "output_bytes": float(out_bytes),
               "alias_bytes": float(alias)}
        if self.exe.place.type == "cuda":
            temp = max(0, self.pool_bytes - sum(b for b, arg in fetched
                                                if not arg))
            out.update(temp_bytes=float(temp), generated_code_bytes=0.0)
            out["peak_hbm_bytes"] = max(
                0.0, arg_bytes + out_bytes + temp - alias)
        return out

    @property
    def _written(self):
        """The persistable names the step writes (outputs of its ops)."""
        program = self.program_ref()
        return {n for blk in program.blocks for op in blk.ops
                for n in op.output_arg_names}

    def _host_op_step(self, program, scope, feed, step):
        """One eager step of a program that holds a host op, on the
        executor's device and current stream; counted and, the first time
        this executor takes one, warned."""
        exe = self.exe
        if not exe.host_op_steps:
            warnings.warn(
                "the captured step (CompiledProgram, run_steps) runs this "
                "program eagerly on %s: it holds op %r (block %d, index %d), "
                "%s" % ((exe.place,) + self.host_op),
                RuntimeWarning, stacklevel=4)
        exe.host_op_steps += 1
        block = program.global_block
        feeds = {n: exe._feed_tensor(block, n, v) for n, v in feed.items()}
        env = exe._eager_step(program, self.plan, scope, feeds,
                              self.fetch_names, step, self.accum)
        return _fetches(env, self.fetch_names)

    def _write_back(self, env):
        """Each state output of ``env`` written back into its static tensor
        with ``copy_`` (one an op updated in place is skipped)."""
        with torch.no_grad():
            for n, held in self.state.items():
                val = env.get(n)
                if val is None or val is held:
                    continue
                if val.shape != held.shape:
                    raise RuntimeError(
                        "captured step: persistable %r came out as %s, its "
                        "static tensor is %s" % (n, list(val.shape),
                                                 list(held.shape)))
                held.copy_(val)

    def _static_body(self, program, step, trace=None):
        """The body on the static state and feeds, each state output
        written back into its static tensor; returns the fetches. A split
        step (:attr:`pieces`) runs piece by piece (:meth:`_run_pieces`)."""
        exe, plan = self.exe, self.plan
        if trace is None:
            trace = TraceContext(program, plan.is_test, exe.place, step,
                                 plan.generators, both_branches=True)
        if self.pieces is not None:
            return self._run_pieces(program, trace)
        env = exe._body(plan, self.state, self.feeds, self.fetch_names, trace,
                        self.accum)
        self._write_back(env)
        return _fetches(env, self.fetch_names)

    def _run_pieces(self, program, trace, capture=None):
        """The split step: each run of ops on the env (the first also makes
        it from the static state and feeds; one before a loop ends by
        copying the loop's carry into new static tensors; the last writes
        the state back and makes the fetches), each loop's body while its
        condition, read on the host, holds. With ``capture`` (a function
        that captures a function into a graph and returns it) nothing runs:
        each run of ops and each loop body is captured once, in order, and
        :attr:`replays` is filled. Returns the fetches."""
        plan, box = self.plan, {}
        replays = []
        for k, (start, end, loop) in enumerate(self.pieces):
            last = k == len(self.pieces) - 1

            def ops(start=start, end=end, loop=loop, first=k == 0,
                    last=last):
                if first:
                    box["env"], box["before"] = _forward_env(
                        plan, self.state, self.feeds)
                env = box["env"]
                with torch.no_grad():
                    run_block_ops(plan.ops[start:end], env, trace,
                                  offset=start)
                    if loop is not None:
                        _, _, carry = _cf.loop_parts(program, loop)
                        _cf.check_carry({n: env[n] for n in carry})
                        env.update({n: _cf.copy_value(env[n])
                                    for n in carry})
                    if last:
                        _forward_done(plan, self.state, env, box["before"])
                        self._write_back(env)
                        box["outs"] = _fetches(env, self.fetch_names)

            empty = start == end and loop is None and k > 0 and (
                plan.amp_dtype is None and not _needs_write_back(
                    self.state, box["env"]))
            if capture is None:
                ops()
            elif empty:
                ops()
                replays.append(("ops", None))
            else:
                replays.append(("ops", capture(ops)))
            if loop is None:
                continue
            block, cond, carry = _cf.loop_parts(program, loop)

            def body(block=block, carry=carry):
                env = box["env"]
                local = dict(env)
                with torch.no_grad():
                    _cf.run_body(block, local, trace)
                    _cf.write_carry(env, local, carry)

            if capture is not None:
                replays.append(("loop", cond, capture(body)))
                continue
            while bool(box["env"][cond].reshape(())):
                body()
        if capture is not None:
            self.replays, self.box = replays, box
        return box["outs"]

    def _replay_pieces(self):
        """One step of a split step on the card: the graph of each run of
        ops; for each loop, the body's graph while the condition (one host
        read an iteration) holds."""
        for entry in self.replays:
            if entry[0] == "ops":
                if entry[1] is not None:
                    entry[1].replay()
                    metrics.REPLAYS.inc()
                continue
            _, cond, body = entry
            while bool(self.box["env"][cond].reshape(())):
                body.replay()
                metrics.REPLAYS.inc()

    def _capture(self, program, scope, step):
        """Take the scope's tensors as the static state, allocate the
        static feeds and, on the card, capture the body (a split step: its
        graphs)."""
        exe, plan = self.exe, self.plan
        state = exe._gather_state(plan, scope)
        for n, t in state.items():
            if scope.find_var(n) is not t:
                scope.set_var(n, t)
        block = program.global_block
        self.state = state
        self.feeds = {
            n: torch.empty(shape, device=exe.place,
                           dtype=_feed_dtype(block, n)
                           or getattr(torch, dtype))
            for n, shape, dtype in self.sig}
        if exe.place.type != "cuda":
            return
        t0 = time.perf_counter()
        if plan.generators and not hasattr(torch.cuda.CUDAGraph(),
                                           "register_generator_state"):
            raise RuntimeError(
                "this torch (%s) cannot register a generator with a CUDA "
                "graph, so a program with stochastic ops cannot be "
                "captured" % torch.__version__)
        plan.reseed(program, step)
        trace = TraceContext(program, plan.is_test, exe.place, step,
                             plan.generators, both_branches=True)
        # torch.cuda.graph empties the allocator's cache on entry; doing it
        # first makes the growth of reserved memory the graphs' pools
        torch.cuda.synchronize(exe.place)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(exe.place)
        graphs = []

        def capture(fn):
            graph = torch.cuda.CUDAGraph()
            for gen, _ in plan.generators.values():
                graph.register_generator_state(gen)
            # no prefetcher worker issues CUDA work during the capture, and
            # the collector frees no dead graph in it (serving/captured.py)
            with CAPTURE_LOCK, gc_paused(), torch.cuda.graph(
                    graph, stream=exe._stream()):
                fn()
            graphs.append(graph)
            return graph

        try:
            if self.pieces is None:
                graph = capture(lambda: setattr(
                    self, "outputs", self._static_body(program, step, trace)))
            else:
                self.outputs = self._run_pieces(program, trace, capture)
        except Exception as e:
            # the next step captures again (and fails again): nothing runs
            # eagerly in the graph's place
            for g in graphs:
                g.reset()
            end_failed_capture(exe._stream(), [
                gen for gen, _ in plan.generators.values()])
            self.state, self.feeds, self.outputs = None, {}, []
            self.replays, self.box = [], {}
            op = _op_at(program, trace.current_op_idx)
            raise RuntimeError(
                "capturing the step into a CUDA graph failed at op %d (%s, "
                "outputs %s); it is not run eagerly in its place. "
                "A captured step may not read a device value on the host "
                "or change shapes: %s: %s"
                % (trace.current_op_idx, getattr(op, "type", None),
                   getattr(op, "output_arg_names", None),
                   type(e).__name__, e)) from e
        if self.pieces is None:
            self.graph = graph
        self.graphs = len(graphs)
        self.pool_bytes = torch.cuda.memory_reserved(exe.place) - before
        self.capture_s = time.perf_counter() - t0
        metrics.CAPTURES.inc(len(graphs))
        metrics.CAPTURE_MS.set(self.capture_s * 1e3)

    def _restore_state(self, scope):
        """Bring back each static tensor an eager ``run()`` (or the user)
        replaced in the scope: copy the scope's value in, set the static
        tensor back."""
        for n, held in self.state.items():
            cur = scope.find_var(n)
            if cur is held:
                continue
            if cur is not None:
                if not isinstance(cur, torch.Tensor):
                    cur = torch.as_tensor(np.asarray(cur))
                if tuple(cur.shape) != tuple(held.shape):
                    raise ValueError(
                        "scope var %r is %s, the captured step's static "
                        "tensor %s" % (n, list(cur.shape), list(held.shape)))
                with torch.no_grad():
                    held.copy_(cur)
            scope.set_var(n, held)


def _eager_reason(program, plan):
    """The first op that keeps a program's captured step eager, as (type,
    block, index, why), or None."""
    trains = plan.bw is not None and plan.marker_idx is not None
    for blk in program.blocks:
        for i, op in enumerate(blk.ops):
            why = None
            if op.type in HOST_OPS:
                why = ("which needs the host while the step runs, and a "
                       "CUDA graph cannot replay that")
            elif op.type == "while" and (blk.idx != 0 or trains):
                why = ("a loop the captured step splits only in the global "
                       "block of a program without backward ops")
            elif op.type == "conditional_block":
                hit = next((o.type for key in ("true_block", "false_block")
                            if op.attrs.get(key, -1) >= 0
                            for o in _cf.block_ops(
                                program, program.blocks[op.attrs[key]])
                            if o.type in INDEXING_OPS), None)
                if hit is not None:
                    why = ("whose branch holds %r, which may index out of "
                           "range when its branch is not taken" % hit)
            if why is not None:
                return op.type, blk.idx, i, why
    return None


def _pieces(plan):
    """(start, end, while op or None) of each run of global-block ops and
    the loop after it, for a forward program holding a ``while``; None for
    any other."""
    loops = [i for i, op in enumerate(plan.ops) if op.type == "while"]
    if not loops:
        return None
    out, start = [], 0
    for i in loops:
        out.append((start, i, plan.ops[i]))
        start = i + 1
    out.append((start, len(plan.ops), None))
    return out


def _needs_write_back(state, env):
    return any(env.get(n) is not None and env.get(n) is not held
               for n, held in state.items())


def _op_at(program, idx):
    """The op at an interpreter position (``10_000 * block.idx + i``)."""
    blk, i = divmod(idx, 10_000)
    if blk < len(program.blocks) and i < len(program.blocks[blk].ops):
        return program.blocks[blk].ops[i]
    return None


def _nbytes(t) -> int:
    if isinstance(t, tuple):
        return sum(_nbytes(v) for v in t)
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _is_argument(t, args) -> bool:
    ptr = t.untyped_storage().data_ptr()
    return any(a.untyped_storage().data_ptr() == ptr for a in args.values())


def _started_readers(program):
    return [r for r in getattr(program, "_py_readers", ()) if r._started]


def _drain_one_batch(program, feed):
    """``feed`` with one batch of each started py_reader of ``program``
    whose vars it does not name (reference: the in-graph ``read`` op
    popping the blocking queue; ``EOFException`` at the end). A feed that
    names some of a started reader's vars but not all raises."""
    readers = _started_readers(program)
    if not readers:
        return feed
    feed = dict(feed or {})
    for reader in readers:
        fed = [n for n in reader.var_names if n in feed]
        if not fed:
            feed.update(reader.next_feed())
        elif len(fed) != len(reader.var_names):
            # mixing an explicit partial feed with queue data would consume
            # a queued batch and pair unrelated rows
            raise ValueError(
                "run(): feed covers only %s of started py_reader vars %s; "
                "feed all of them or none" % (fed, list(reader.var_names)))
    return feed


def _drain_readers(program):
    """Feed dicts from the started py_readers of ``program``, one batch of
    each a step, until one raises ``EOFException``."""
    readers = _started_readers(program)
    if not readers:
        raise ValueError(
            "run_steps() needs a feed_iter or a started py_reader bound to "
            "the program")

    def drain():
        while True:
            f = {}
            try:
                for r in readers:
                    f.update(r.next_feed())
            except EOFException:
                return
            yield f

    return drain()


def _feed_dtype(block, name):
    return to_torch_dtype(block.var(name).dtype) if block.has_var(name) \
        else None


def _feed_signature(feed):
    """((name, shape, dtype), ...) of a feed dict, sorted by name, and the
    feed with list or scalar values converted to numpy once."""
    sig, conv = [], {}
    for n in sorted(feed):
        v = feed[n]
        if not isinstance(v, (torch.Tensor, np.ndarray)):
            v = np.asarray(v)
        conv[n] = v
        sig.append((n, tuple(v.shape), str(v.dtype).replace("torch.", "")))
    return tuple(sig), conv


def _concrete_feed(feed):
    """``feed`` with each ``(shape, dtype)`` tuple made a tensor of zeros
    (an array stays as it is)."""
    out = {}
    for n, v in feed.items():
        if isinstance(v, tuple) and len(v) == 2 and not hasattr(v, "dtype"):
            shape, dtype = v
            v = torch.zeros(tuple(shape), dtype=to_torch_dtype(dtype))
        out[n] = v
    return out


def _microbatches(feeds, accum):
    """The feeds as ``accum`` microbatches, each a dict of dim-0 slices
    (views); a batch that ``accum`` does not divide raises, as the JAX
    package's reshape does."""
    if accum <= 1:
        return [feeds]
    for n, v in feeds.items():
        if v.dim() == 0 or v.shape[0] % accum:
            raise ValueError(
                "gradient_accumulation_steps = %d does not divide feed %r "
                "of shape %s along dim 0" % (accum, n, list(v.shape)))
    return [{n: v[i * (v.shape[0] // accum):(i + 1) * (v.shape[0] // accum)]
             for n, v in feeds.items()} for i in range(accum)]


def _fetches(env, fetch_names) -> List[torch.Tensor]:
    missing = [f for f in fetch_names if f not in env]
    if missing:
        raise KeyError("fetch of %s: not computed by the program and not "
                       "in the scope" % missing)
    return [env[f].detach() for f in fetch_names]


def _forward_env(plan, state, feeds):
    """(env, its values before the ops) of a step without backward ops:
    the state and feeds, under AMP cast copies (the float32 state survives
    an eval or fetch run as it was; :func:`_forward_done`)."""
    env = dict(state)
    env.update(feeds)
    if plan.amp_dtype is None:
        return env, None
    env = _amp_cast(env, plan.amp_dtype)
    return env, dict(env)


def _forward_done(plan, state, env, before):
    """Under AMP, only what an op rewrote (another tensor under the name)
    goes back, in the state's dtype; the rest is the state as it was."""
    if plan.amp_dtype is None:
        return
    for n, held in state.items():
        val = env.get(n)
        if val is before.get(n):
            env[n] = held
        elif val is not None and val.dtype != held.dtype:
            env[n] = val.to(held.dtype)


def _amp_cast(tensors: Dict[str, torch.Tensor], dtype) -> Dict[str, Any]:
    """``tensors`` with every float32 one cast to ``dtype`` (as they are
    for ``dtype`` None)."""
    if dtype is None:
        return tensors
    return {n: v.to(dtype) if isinstance(v, torch.Tensor)
            and v.dtype == torch.float32 else v for n, v in tensors.items()}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
