# ported from paddle_tpu/core/pass_framework.py
"""User-extensible Program-pass framework.

Reference: ``framework/ir/pass.h:32`` (Pass base), ``REGISTER_PASS``
(``pass.h:207``), and the PassBuilder exposed at ``pybind/pybind.cc:981-1003``
(``BuildStrategy::CreatePassesFromStrategy`` / append/insert/remove).

The reference's passes rewrite an ``ir::Graph`` lowered from ProgramDesc; here,
as in the JAX package, the IR *is* the Program (Block/Operator/Variable,
``core/framework.py``). Program passes are for the rewrites that route a
primitive-built program onto the fused ops and their kernels, inference-time
weight folding (conv+bn), pruning and user instrumentation. Passes run in
PassBuilder order inside ``CompiledProgram``'s build step, in the default
pipeline the Executor runs (``paddle_tpu_torch/passes``), or standalone via
``Pass.apply``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Union

__all__ = ["Pass", "FunctionPass", "PassError", "register_pass", "get_pass",
           "has_pass", "registered_passes", "PassBuilder"]


class PassError(RuntimeError):
    """A pass failed mid-pipeline. Carries ``pass_name`` so the
    transactional-clone error path (``CompiledProgram._apply_build_passes``)
    can say WHICH pass died instead of losing it in the traceback."""

    def __init__(self, pass_name: str, original: BaseException):
        self.pass_name = pass_name
        self.original = original
        super().__init__(
            "pass %r failed: %s: %s"
            % (pass_name, type(original).__name__, original))


class Pass:
    """Base class. Subclasses set ``name`` (or get it from ``register_pass``)
    and implement ``apply_impl(program)``; mutate the program in place and/or
    return it (returning None means "mutated in place").

    Like the reference's ``Pass::Set/Get`` attribute bag (``pass.h:51-99``),
    ``set_attr``/``attr`` carry side inputs such as the Scope holding
    parameter values (weight-folding passes need them).
    """

    name: str = ""

    def __init__(self):
        self._attrs: Dict[str, Any] = {}

    # -- attribute bag --------------------------------------------------------
    def set_attr(self, key: str, value) -> "Pass":
        self._attrs[key] = value
        return self

    def attr(self, key: str, default=None):
        return self._attrs.get(key, default)

    def has_attr(self, key: str) -> bool:
        return key in self._attrs

    # -- application ----------------------------------------------------------
    def apply(self, program):
        from ..monitor import metrics as _mx

        t0 = time.perf_counter() if _mx._enabled else 0.0
        out = self.apply_impl(program)
        program = out if out is not None else program
        program._version += 1  # invalidate executor program caches
        if _mx._enabled:
            _mx.histogram(
                "passes/%s/time_ms" % (self.name or type(self).__name__)
            ).observe((time.perf_counter() - t0) * 1e3)
        return program

    def apply_impl(self, program):
        raise NotImplementedError(
            "Pass %r must implement apply_impl(program)" % type(self).__name__)

    def __repr__(self):
        return "<Pass %s>" % (self.name or type(self).__name__)


class FunctionPass(Pass):
    """Adapter: a plain ``fn(program, pass_) -> Program|None`` as a Pass."""

    def __init__(self, name: str, fn: Callable):
        super().__init__()
        self.name = name
        self._fn = fn

    def apply_impl(self, program):
        return self._fn(program, self)


_PASS_REGISTRY: Dict[str, Callable[[], Pass]] = {}


def register_pass(name: str):
    """Decorator registering a Pass subclass or a function
    (reference: REGISTER_PASS, ir/pass.h:207). Re-registration under the
    same name is an error, matching the reference's static-registrar check."""

    def deco(obj):
        if name in _PASS_REGISTRY:
            raise ValueError("pass %r registered twice" % name)
        if isinstance(obj, type) and issubclass(obj, Pass):
            obj.name = name
            _PASS_REGISTRY[name] = obj
        elif callable(obj):
            _PASS_REGISTRY[name] = lambda: FunctionPass(name, obj)
        else:
            raise TypeError("register_pass: need a Pass subclass or callable")
        return obj

    return deco


def get_pass(name: str) -> Pass:
    try:
        factory = _PASS_REGISTRY[name]
    except KeyError:
        raise KeyError(
            "pass %r is not registered (known: %s)"
            % (name, sorted(_PASS_REGISTRY))) from None
    return factory()


def has_pass(name: str) -> bool:
    return name in _PASS_REGISTRY


def registered_passes() -> List[str]:
    return sorted(_PASS_REGISTRY)


class PassBuilder:
    """Ordered pass pipeline (reference: PassBuilder at pybind.cc:981-1003:
    append_pass/insert_pass/remove_pass over BuildStrategy's pipeline)."""

    def __init__(self, passes: Optional[List[Union[str, Pass]]] = None):
        self._passes: List[Pass] = []
        for p in passes or []:
            self.append_pass(p)

    def _coerce(self, p: Union[str, Pass]) -> Pass:
        return get_pass(p) if isinstance(p, str) else p

    def append_pass(self, p: Union[str, Pass]) -> Pass:
        p = self._coerce(p)
        self._passes.append(p)
        return p

    def insert_pass(self, idx: int, p: Union[str, Pass]) -> Pass:
        p = self._coerce(p)
        self._passes.insert(idx, p)
        return p

    def remove_pass(self, idx: int) -> None:
        del self._passes[idx]

    def all_passes(self) -> List[Pass]:
        return list(self._passes)

    def apply_all(self, program):
        """Apply every pass in order. A failing pass is re-raised as
        :class:`PassError` naming it — callers running the pipeline on a
        transactional clone (``CompiledProgram._apply_build_passes``) keep
        the original program untouched AND know which pass to blame."""
        for p in self._passes:
            try:
                program = p.apply(program)
            except PassError:
                raise  # nested builders: keep the innermost attribution
            except Exception as e:
                raise PassError(p.name or type(p).__name__, e) from e
        return program
