# ported from paddle_tpu/contrib/slim/core/compress_pass.py
"""Compression driver (reference: contrib/slim/core/compress_pass.py —
CompressPass walks epochs/batches calling each Strategy's callbacks).

The context carries what strategies need: the scope (weight surgery
between steps reads and replaces its tensors, with no mask programs), the
executor, the graph wrapper, and epoch/batch counters.
"""

from __future__ import annotations

from ....core.scope import global_scope
from ..graph.graph import ImitationGraph

__all__ = ["Context", "CompressPass", "build_compressor"]


class Context:
    def __init__(self, graph, scope, program_exe=None, place=None):
        self.graph = graph
        self.scope = scope
        self.program_exe = program_exe
        self.place = place
        self.epoch_id = 0
        self.batch_id = 0


class CompressPass:
    """reference: CompressPass.apply — run the training loop with strategy
    callbacks around it. ``data_reader`` yields feed dicts; ``train_step``
    is called per batch (defaults to exe.run of the given program)."""

    def __init__(self, place=None, data_reader=None, epoch=1,
                 program_exe=None, scope=None):
        self.place = place
        self.data_reader = data_reader
        self.epoch = epoch
        self.program_exe = program_exe
        self.scope = scope
        self.strategies = []

    def add_strategy(self, strategy):
        self.strategies.append(strategy)
        return self

    def apply(self, graph_or_program, train_step=None):
        graph = (graph_or_program
                 if isinstance(graph_or_program, ImitationGraph)
                 else ImitationGraph(graph_or_program))
        context = Context(graph, self.scope or global_scope(),
                          program_exe=self.program_exe, place=self.place)
        for s in self.strategies:
            s.on_compress_begin(context)
        for epoch in range(self.epoch):
            context.epoch_id = epoch
            for s in self.strategies:
                s.on_epoch_begin(context)
            context.batch_id = 0
            for feed in (self.data_reader() if self.data_reader else ()):
                for s in self.strategies:
                    s.on_batch_begin(context)
                if train_step is not None:
                    train_step(context, feed)
                elif self.program_exe is not None:
                    self.program_exe.run(graph.program, feed=feed)
                for s in self.strategies:
                    s.on_batch_end(context)
                context.batch_id += 1
            for s in self.strategies:
                s.on_epoch_end(context)
        for s in self.strategies:
            s.on_compress_end(context)
        return context


def build_compressor(place=None, data_reader=None, epoch=1, program_exe=None,
                     scope=None, strategies=None):
    """reference: contrib/slim/core/compress_pass.py build_compressor."""
    c = CompressPass(place=place, data_reader=data_reader, epoch=epoch,
                     program_exe=program_exe, scope=scope)
    for s in strategies or []:
        c.add_strategy(s)
    return c
