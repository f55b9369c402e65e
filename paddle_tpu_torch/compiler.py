# ported from paddle_tpu/compiler.py
"""CompiledProgram: the captured step's front door.

Reference: ``python/paddle/fluid/compiler.py:62``. The JAX package
compiles a program's whole step into one XLA dispatch, under a mesh when
it runs data parallel. On the one card of the port, "compiled" means
captured: ``Executor.run(CompiledProgram(main))`` and
``Executor.run_steps`` warm the program's eager step up, capture it once
into a CUDA graph for each feed signature and replay it
(``executor._CapturedStep``). The graph replays the eager step's kernels
as they were launched, so the strategies' scheduling and memory knobs
have nothing to act on: they are accepted and warn.

Control flow is captured as the JAX package compiles it: a
``conditional_block`` (``cond``, ``Switch``) runs both branches and
selects each output on the device, and a ``while`` in the global block of
a program without backward ops splits the step into graphs, one a run of
ops and one a loop body, replayed once an iteration after a host read of
the condition (``executor._CapturedStep``). A program that holds a host
op (``executor.HOST_OPS``: ``print``, ``py_func``, ``tree_conv``), a
``while`` anywhere else or a branch that indexes by its data
(``executor.INDEXING_OPS``) holds work no graph replays: each of its
steps runs eagerly on the executor's device, as ``Executor.run`` runs it,
counted by ``Executor.host_op_steps``, and the first one warns, naming
the op.

``BuildStrategy.pass_builder()`` is the user's Program-pass pipeline, run
once at the first execution on a transactional clone after the fetch-safe
default passes (``_apply_build_passes``); a failing pass leaves the
program untouched and names itself. ``gradient_accumulation_steps``
splits each step's batch into that many microbatches
(``Executor._train_step``), captured as one graph.

Left out against the JAX package: ``with_mesh`` and more than one place
(ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

from .core.framework import Program

__all__ = ["CompiledProgram", "ExecutionStrategy", "BuildStrategy"]

_GRAPH_REPLAYS = ("a CUDA graph replays the eager step's kernels in the "
                  "order they were launched")
_ALLOCATOR = ("the caching allocator and the CUDA graph's memory pool own "
              "memory reuse")


class _StrategyBase:
    """Attribute holder that says what it ignores: setting a knob that has
    no effect on the captured step warns, naming what owns the behaviour
    instead."""

    _INERT: dict = {}  # attr -> who handles it now
    _defaults: dict = {}

    def __setattr__(self, name, value):
        if name in self._INERT and value != self._defaults.get(name):
            warnings.warn(
                "%s.%s is accepted for API compatibility but has no effect: %s"
                % (type(self).__name__, name, self._INERT[name]),
                UserWarning, stacklevel=2)
        object.__setattr__(self, name, value)


class ExecutionStrategy(_StrategyBase):
    """API parity with details/execution_strategy.h:22; every knob is
    inert on the captured step."""

    _INERT = {
        "num_threads": _GRAPH_REPLAYS + " on one stream",
        "num_iteration_per_drop_scope": _ALLOCATOR,
        "use_experimental_executor": "there is one executor (the eager "
            "step, captured into a CUDA graph)",
    }

    def __init__(self):
        d = {"num_threads": 0, "num_iteration_per_drop_scope": 1,
             "use_experimental_executor": False}
        object.__setattr__(self, "_defaults", d)
        for k, v in d.items():
            object.__setattr__(self, k, v)


class BuildStrategy(_StrategyBase):
    """API parity with details/build_strategy.h:35."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    _INERT = {
        "memory_optimize": _ALLOCATOR,
        "enable_inplace": _ALLOCATOR + "; the sparse row updates write "
            "their tables in place already",
        "fuse_all_reduce_ops": "one card runs no all-reduce",
        "gradient_scale_strategy": "on one card the loss is the batch "
            "mean already, which is CoeffNumDevice with one device",
    }

    def __init__(self):
        d = {
            "reduce_strategy": BuildStrategy.ReduceStrategy.AllReduce,
            "gradient_scale_strategy":
                BuildStrategy.GradientScaleStrategy.CoeffNumDevice,
            "memory_optimize": True,
            "enable_inplace": True,
            "fuse_all_reduce_ops": True,
            "num_trainers": 1,
            "trainer_id": 0,
            "gradient_accumulation_steps": 1,
        }
        object.__setattr__(self, "_defaults", d)
        for k, v in d.items():
            object.__setattr__(self, k, v)
        object.__setattr__(self, "_pass_builder", None)

    def pass_builder(self):
        """The Program-pass pipeline applied in CompiledProgram's build step
        (reference: BuildStrategy::CreatePassesFromStrategy + PassBuilder,
        pybind.cc:981-1003). Created empty on first call; append registered
        or custom passes."""
        from .core.pass_framework import PassBuilder

        if self._pass_builder is None:
            object.__setattr__(self, "_pass_builder", PassBuilder())
        return self._pass_builder


class CompiledProgram:
    """reference: compiler.py:62."""

    def __init__(self, program_or_graph: Program):
        self._program = program_or_graph
        self._build_strategy: Optional[BuildStrategy] = None

    def with_data_parallel(
        self,
        loss_name: Optional[str] = None,
        build_strategy: Optional[BuildStrategy] = None,
        exec_strategy: Optional[ExecutionStrategy] = None,
        share_vars_from: Optional["CompiledProgram"] = None,
        places: Optional[Sequence] = None,
    ) -> "CompiledProgram":
        """reference: compiler.py:116. With ``places`` None or one place
        the program runs on the executor's one device, where ``loss_name``,
        ``exec_strategy``, ``share_vars_from`` and ``reduce_strategy =
        Reduce`` change nothing (the reference also returns at ``mesh is
        None``)."""
        if places is not None and len(places) > 1:
            raise NotImplementedError(
                "with_data_parallel(places=%d places): the port runs on one "
                "card; meshes are queued in ROADMAP Queue 1 item 7"
                % len(places))
        self._build_strategy = build_strategy or BuildStrategy()
        return self

    def with_mesh(self, axes, loss_name: Optional[str] = None,
                  build_strategy: Optional[BuildStrategy] = None):
        """The reference's N-D mesh parallelism: not ported."""
        raise NotImplementedError(
            "CompiledProgram.with_mesh(): the port runs on one card; meshes "
            "and sharded state are queued in ROADMAP Queue 1 item 7")

    def _checked_program(self, scope=None):
        """(the program to run, gradient accumulation steps), after the
        build passes (:meth:`_apply_build_passes`)."""
        self._apply_build_passes(scope)
        bs = self._build_strategy
        accum = 1 if bs is None else int(bs.gradient_accumulation_steps)
        if accum < 1:
            raise ValueError("BuildStrategy.gradient_accumulation_steps must "
                             "be >= 1, got %d" % accum)
        return self._program, accum

    def _apply_build_passes(self, scope):
        """Run the BuildStrategy's PassBuilder pipeline once, at first
        execution (the reference applies its pass pipeline when the
        ParallelExecutor graph is built, build_strategy.cc:44-150).

        The default pipeline (``passes``, gated by ``PADDLE_TPU_OPT_LEVEL``)
        runs first on the same transactional clone, so user pipelines
        compose AFTER the defaults, as the reference's
        BuildStrategy::CreatePassesFromStrategy orders them. With no fetch
        info at build time only the FETCH-SAFE defaults run (conv+bn
        folding, conservative DCE); the Executor runs the full fetch-seeded
        pipeline on the result (memoized; every default pass is
        idempotent)."""
        if getattr(self, "_passes_applied", False):
            return
        bs = self._build_strategy
        builder = getattr(bs, "_pass_builder", None) if bs is not None else None
        if builder is None:
            # no user pipeline: the Executor applies the defaults per fetch
            # set, where DCE can seed liveness from real fetch targets
            self._passes_applied = True
            return
        from .core.scope import global_scope
        from .passes.analysis import stamp_rng_slots
        from .passes.pipeline import default_pipeline

        scope = scope if scope is not None else global_scope()
        for p in builder.all_passes():
            if not p.has_attr("scope"):
                p.set_attr("scope", scope)
        # transactional: passes may mutate the program in place, so run the
        # pipeline on a clone — a mid-pipeline failure (PassError, naming
        # the failing pass) leaves the original untouched and the retry
        # starts from scratch instead of double-applying the passes that
        # had already run
        work = self._program.clone()
        # freeze stochastic ops' positional streams before any rewrite
        # (passes/analysis.py): op deletion must not shift them
        stamp_rng_slots(work)
        work = default_pipeline(scope=scope).apply_all(work)
        self._program = builder.apply_all(work)
        self._passes_applied = True

    # -- execution (called from Executor.run) ---------------------------------
    def _run(self, executor, feed, fetch_list, scope, return_numpy):
        """One step through the executor's captured step; returns what
        ``Executor.run`` returns."""
        out = executor.run_steps(self, [feed or {}], steps=1,
                                 fetch_list=fetch_list, scope=scope,
                                 return_numpy=return_numpy)
        if not out:
            return []
        return out[0] if return_numpy else out[0].raw
