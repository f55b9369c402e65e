"""Carrying a program's state into the port as arrays.

The JAX package initialises weights with threefry, which torch cannot
redraw, so a run that must start from the same weights copies them:
:func:`state_from_numpy` takes ``{var name: numpy array}`` (as
``np.asarray(jax_scope.find_var(name))`` gives each) and puts every
persistable var of a program into a port ``Scope`` as a tensor. Both
packages build programs with the same layer functions and the same name
generator, so their var names match one for one.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .core.dtypes import to_torch_dtype
from .core.place import resolve_device
from .core.scope import Scope, global_scope

__all__ = ["state_from_numpy"]


def state_from_numpy(program, arrays: Mapping[str, np.ndarray],
                     scope: Optional[Scope] = None, place=None) -> Scope:
    """Set every persistable var of ``program`` in ``scope`` (the global
    scope by default) from ``arrays``, as a tensor on ``place`` (the card
    by default) in the var's declared dtype. Raises ``KeyError`` when a
    persistable var has no array and ``ValueError`` when an array's shape
    is not the var's. Arrays for other names are not read. Returns the
    scope."""
    dev = resolve_device(place)
    scope = global_scope() if scope is None else scope
    persistables = {v.name: v for v in program.list_vars() if v.persistable}
    missing = sorted(n for n in persistables if n not in arrays)
    if missing:
        raise KeyError("no array for persistable vars %s" % missing)
    for name, var in sorted(persistables.items()):
        arr = np.asarray(arrays[name])
        if var.shape is not None and tuple(arr.shape) != tuple(var.shape):
            raise ValueError("%s: array shape %s, var shape %s"
                             % (name, tuple(arr.shape), tuple(var.shape)))
        if arr.dtype.name == "bfloat16":  # ml_dtypes: torch cannot read it
            arr = arr.astype(np.float32)
        scope.set_var(name, torch.tensor(arr).to(
            device=dev, dtype=to_torch_dtype(var.dtype)))
    return scope
