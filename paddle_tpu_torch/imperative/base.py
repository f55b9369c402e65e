# ported from paddle_tpu/imperative/base.py
"""Imperative mode entry points (reference: python/paddle/fluid/imperative/base.py:29,47).

``guard()`` activates a Tracer; inside it, ops run eagerly with autograd
(see tracer.py) on the guard's device, and ``to_variable`` lifts numpy
arrays onto it. ``save_dygraph`` writes the JAX package's ``.npz`` file,
so either package reads the other's.
"""

from __future__ import annotations

import contextlib

import numpy as np

from ..core import unique_name
from ..core.place import resolve_device
from . import tracer as tracer_mod
from .tracer import Tracer, VarBase

__all__ = ["enabled", "guard", "to_variable", "save_dygraph", "load_dygraph"]


def enabled() -> bool:
    """reference: framework._in_imperative_mode()."""
    return tracer_mod.current_tracer() is not None


@contextlib.contextmanager
def guard(place=None, seed: int = 0):
    """Enter imperative mode (reference: imperative/base.py:29).

    No ``place`` means the card (``RuntimeError`` without one);
    ``CPUPlace()`` runs every op on the CPU. The JAX package ignores the
    place (XLA owns placement).
    """
    t = Tracer(seed=seed, device=resolve_device(place))
    tracer_mod._TRACER_STACK.append(t)
    try:
        with unique_name.guard():
            yield t
    finally:
        tracer_mod._TRACER_STACK.pop()


def to_variable(value, block=None, name=None) -> VarBase:
    """Lift a numpy array (or VarBase, passthrough) to an eager variable
    on the guard's device (reference: imperative/base.py:47)."""
    if isinstance(value, VarBase):
        return value
    if not enabled():
        raise RuntimeError("to_variable could only be called in imperative mode "
                           "(inside paddle_tpu_torch.imperative.guard())")
    return VarBase(np.asarray(value), name=name)


def save_dygraph(state_or_layer, model_path: str):
    """Save a Layer's (or dict of VarBase) state to ``model_path`` + ".npz"
    (reference: the dygraph save_persistables / later save_dygraph API)."""
    from .layers import Layer  # local: layers imports this module's guard

    state = state_or_layer.state_dict() if isinstance(state_or_layer, Layer) \
        else dict(state_or_layer)
    arrays = {name: v.numpy() if isinstance(v, VarBase) else np.asarray(
        v.detach().cpu() if hasattr(v, "detach") else v)
        for name, v in state.items()}
    np.savez(model_path + ".npz", **arrays)


def load_dygraph(model_path: str):
    """→ {name: np.ndarray}; pair with ``Layer.set_state``."""
    with np.load(model_path + ".npz") as data:
        return {k: data[k] for k in data.files}
