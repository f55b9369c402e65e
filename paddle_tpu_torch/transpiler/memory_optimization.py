# ported from paddle_tpu/transpiler/memory_optimization.py
"""Memory-optimization transpiler shims (reference:
transpiler/memory_optimization_transpiler.py — liveness-based var reuse).

On the card memory reuse belongs to PyTorch's caching allocator, which
hands a freed block to the next tensor of its size class as soon as the
eager step drops its last reference, and to each CUDA graph's private
memory pool, whose addresses the graph's replays reuse. A program rewrite
that renames vars for reuse would change neither, so these are accepted
no-ops that return the program unchanged, kept for script compatibility.
"""

from __future__ import annotations

__all__ = ["memory_optimize", "release_memory"]


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=False):
    return input_program


def release_memory(input_program, skip_opt_set=None):
    return input_program
