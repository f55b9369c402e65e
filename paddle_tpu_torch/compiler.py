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

Left out against the JAX package: ``with_mesh`` and more than one place
(ROADMAP Queue 1 item 7), gradient accumulation and the pass pipeline
(Queue 1 item 3).
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

    def pass_builder(self):
        """The reference's Program-pass pipeline: not ported."""
        raise NotImplementedError(
            "BuildStrategy.pass_builder(): the port has no pass framework; "
            "the passes are queued in ROADMAP Queue 1 item 3")


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

    def _checked_program(self) -> Program:
        """The wrapped program, after refusing what the port lacks."""
        bs = self._build_strategy
        if bs is not None and bs.gradient_accumulation_steps > 1:
            raise NotImplementedError(
                "BuildStrategy.gradient_accumulation_steps = %d: gradient "
                "accumulation is queued in ROADMAP Queue 1 item 3"
                % bs.gradient_accumulation_steps)
        return self._program

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
