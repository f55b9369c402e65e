# ported from paddle_tpu/contrib/slim/graph/graph.py
"""Graph wrappers (reference: contrib/slim/graph/graph.py — Graph /
ImitationGraph hold the Program and expose op/param iteration for
strategies)."""

from __future__ import annotations

__all__ = ["Graph", "ImitationGraph"]


class Graph:
    def all_parameters(self):
        raise NotImplementedError


class ImitationGraph(Graph):
    def __init__(self, program=None):
        from ....core.framework import default_main_program

        self.program = program or default_main_program()

    def all_parameters(self):
        return self.program.all_parameters()

    def all_ops(self):
        return [op for b in self.program.blocks for op in b.ops]
