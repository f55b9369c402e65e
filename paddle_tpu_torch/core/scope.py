# ported from paddle_tpu/core/scope.py
"""Scope: name → device array state.

Fluid's ``Scope`` (``framework/scope.h:48``) is a hierarchical name→Variable
map mutated in place by C++ kernels. In the port it is a flat
name→torch.Tensor dict: the Executor reads the persistable state from it
before a step and writes the updated tensors back after the step.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

__all__ = ["Scope", "global_scope", "scope_guard"]


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self.parent = parent
        self.vars: Dict[str, Any] = {}

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        return self.find_var(name) is not None

    def set_var(self, name: str, value):
        self.vars[name] = value

    def erase(self, name: str):
        self.vars.pop(name, None)

    def new_scope(self) -> "Scope":
        return Scope(parent=self)

    def local_var_names(self):
        return list(self.vars)

    def as_numpy(self, name: str) -> np.ndarray:
        v = self.find_var(name)
        if v is None:
            raise KeyError("Variable %r not found in scope" % name)
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.asarray(v)

    def __contains__(self, name: str):
        return self.has_var(name)

    def __len__(self):
        return len(self.vars)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope) -> Iterator[None]:
    """Temporarily swap the global scope (reference: executor.py:53)."""
    global _global_scope
    prev, _global_scope = _global_scope, scope
    try:
        yield
    finally:
        _global_scope = prev
