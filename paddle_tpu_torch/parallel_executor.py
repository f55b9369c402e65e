# ported from paddle_tpu/parallel_executor.py
"""Legacy ParallelExecutor API (reference:
python/paddle/fluid/parallel_executor.py — a deprecated wrapper the
reference itself routes to CompiledProgram + Executor; scripts that
instantiate it directly must keep running).

The port makes the mapping ``CompiledProgram`` makes: with one card the
program runs data parallel over one place, ``with_data_parallel`` on the
executor's device, so each :meth:`ParallelExecutor.run` is one captured
step (``executor._CapturedStep``: eager warm-ups, then CUDA graph
replays). ``use_cuda=True`` runs on the card and raises where PyTorch sees
no GPU; ``use_cuda=False`` runs on the CPU. Each run adds one to the
``parallel_executor/runs`` counter (:mod:`.monitor.metrics`). The JAX
package's ``parallel_executor/run`` tracer span waits for
``monitor.tracer`` (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import warnings

import torch

from .compiler import BuildStrategy, CompiledProgram, ExecutionStrategy
from .core.framework import default_main_program
from .core.place import CPUPlace, CUDAPlace
from .core.scope import global_scope
from .executor import Executor
from .monitor import metrics as _mx

__all__ = ["ParallelExecutor"]

_m_runs = _mx.counter("parallel_executor/runs",
                      help="ParallelExecutor.run invocations (legacy wrapper)")


class ParallelExecutor:
    def __init__(self, use_cuda, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None, build_strategy=None,
                 num_trainers=1, trainer_id=0, scope=None):
        warnings.warn(
            "ParallelExecutor is deprecated. Please use CompiledProgram and "
            "Executor (compiler.py).", DeprecationWarning, stacklevel=2)
        build_strategy = build_strategy or BuildStrategy()
        build_strategy.num_trainers = num_trainers
        build_strategy.trainer_id = trainer_id
        self._program = main_program or default_main_program()
        self._scope = scope or global_scope()
        self._places = [CUDAPlace(0)] if use_cuda else [CPUPlace()]
        self._compiled = CompiledProgram(self._program).with_data_parallel(
            loss_name=loss_name,
            build_strategy=build_strategy,
            exec_strategy=exec_strategy or ExecutionStrategy(),
            share_vars_from=getattr(share_vars_from, "_compiled",
                                    share_vars_from),
        )
        self._exe = Executor(self._places[0])

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        """reference: parallel_executor.py:123 (feed_dict is the deprecated
        alias feed wins over)."""
        if feed is None:
            feed = feed_dict
        _m_runs.inc()
        return self._exe.run(self._compiled, feed=feed, fetch_list=fetch_list,
                             scope=self._scope, return_numpy=return_numpy)

    @property
    def device_count(self) -> int:
        """The devices of the place's type: the cards PyTorch sees, or the
        one CPU."""
        if self._exe.place.type == "cuda":
            return torch.cuda.device_count()
        return 1
