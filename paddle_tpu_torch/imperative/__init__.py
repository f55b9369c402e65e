# ported from paddle_tpu/imperative/__init__.py
"""Imperative (dygraph) mode — eager execution on torch's autograd.

Reference side stack: paddle/fluid/imperative/ (layer.h, tracer.cc) +
python/paddle/fluid/imperative/ (base.py, layers.py, nn.py). Design notes
in tracer.py (the tape) and jit.py (the captured step).
"""

from . import functional  # noqa: F401
from .base import enabled, guard, load_dygraph, save_dygraph, to_variable  # noqa: F401
from .jit import jit, jit_train  # noqa: F401
from .layers import Layer, PyLayer  # noqa: F401
from .nn import FC, BatchNorm, Conv2D, Embedding, Pool2D  # noqa: F401
from .tracer import EagerBlock, Tracer, VarBase, current_tracer, dispatch, trace_fn  # noqa: F401

F = functional

__all__ = [
    "enabled", "guard", "to_variable", "save_dygraph", "load_dygraph", "Layer", "PyLayer",
    "FC", "BatchNorm", "Conv2D", "Embedding", "Pool2D",
    "VarBase", "Tracer", "current_tracer", "dispatch", "trace_fn", "F",
    "functional", "EagerBlock", "jit", "jit_train",
]
