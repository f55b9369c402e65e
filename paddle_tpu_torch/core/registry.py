# ported from paddle_tpu/core/registry.py
"""Op registry: symbolic op type → PyTorch implementation.

The replacement of Fluid's kernel registry
(``framework/op_registry.h:197,237,240`` + ``OperatorWithKernel::RunImpl``
``framework/operator.cc:877``). Fluid keys kernels by (place, dtype, layout,
library); here each op type has ONE function over torch tensors, run
eagerly by the interpreter on the tensors' device (a CUDA device, the CPU,
or the ``meta`` device of shape inference).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

__all__ = ["register_op", "get_op_impl", "has_op", "registered_ops", "OpContext"]

_OP_REGISTRY: Dict[str, Callable] = {}


def register_op(*types: str):
    """Decorator registering an impl for one or more op type names.

    Impl signature: ``fn(ctx: OpContext) -> None`` — reads inputs/attrs from
    ctx, writes outputs via ``ctx.set_output``.
    """

    def deco(fn):
        for t in types:
            if t in _OP_REGISTRY:
                raise ValueError("op %r registered twice" % t)
            _OP_REGISTRY[t] = fn
        return fn

    return deco


def get_op_impl(type_: str) -> Callable:
    try:
        return _OP_REGISTRY[type_]
    except KeyError:
        raise NotImplementedError(
            "Op %r has no implementation registered in paddle_tpu_torch. "
            "Registered ops: %d. (Not ported yet — add it in "
            "paddle_tpu_torch/ops/.)"
            % (type_, len(_OP_REGISTRY))
        ) from None


def has_op(type_: str) -> bool:
    return type_ in _OP_REGISTRY


def registered_ops() -> List[str]:
    return sorted(_OP_REGISTRY)


class OpContext:
    """Execution context handed to op impls during program tracing.

    The analog of Fluid's ``ExecutionContext`` (``framework/operator.h:203``):
    values live in a name→tensor environment dict owned by the interpreter,
    and outputs are written back into it.
    """

    def __init__(self, op, env: Dict[str, Any], trace):
        self.op = op
        self.env = env
        self.trace = trace  # TraceContext: rng, mode, device, op index

    # -- inputs ---------------------------------------------------------------
    def input(self, slot: str):
        """Single input value for a slot (None if absent)."""
        names = self.op.inputs.get(slot)
        if not names:
            return None
        return self._lookup(names[0])

    def inputs(self, slot: str) -> List[Any]:
        return [self._lookup(n) for n in self.op.inputs.get(slot, [])]

    def has_input(self, slot: str) -> bool:
        return bool(self.op.inputs.get(slot))

    def _lookup(self, name: str):
        if name not in self.env:
            raise KeyError(
                "Op %r reads var %r which is not materialized. "
                "Feed it, initialize it in the startup program, or check op order."
                % (self.op.type, name)
            )
        return self.env[name]

    # -- outputs --------------------------------------------------------------
    def output_name(self, slot: str) -> Optional[str]:
        names = self.op.outputs.get(slot)
        return names[0] if names else None

    def output_names(self, slot: str) -> List[str]:
        return self.op.outputs.get(slot, [])

    def has_output(self, slot: str) -> bool:
        return bool(self.op.outputs.get(slot))

    def set_output(self, slot: str, value, index: int = 0):
        names = self.op.outputs.get(slot)
        if not names:
            return  # optional output not wired
        self.env[names[index]] = value

    def set_outputs(self, slot: str, values):
        names = self.op.outputs.get(slot, [])
        for n, v in zip(names, values):
            self.env[n] = v

    # -- attrs / metadata -----------------------------------------------------
    def attr(self, name: str, default=None):
        return self.op.attrs.get(name, default)

    def var(self, name: str):
        """Symbolic Variable metadata (shape/dtype) for a var name."""
        return self.op.block.var(name)

    def input_var(self, slot: str):
        names = self.op.inputs.get(slot)
        return self.op.block.var(names[0]) if names else None

    def output_var(self, slot: str):
        names = self.op.outputs.get(slot)
        return self.op.block.var(names[0]) if names else None

    @property
    def is_test(self) -> bool:
        if "is_test" in self.op.attrs:
            return bool(self.op.attrs["is_test"])
        return self.trace.is_test

    @property
    def device(self):
        """The device this run's tensors live on: ops that create a tensor
        from nothing (fill_constant, the random ops) place it here."""
        return self.trace.device

    def rng(self):
        """Per-op ``torch.Generator`` on :attr:`device`, seeded from (seed
        attr or program seed, step index, op position); None under shape
        inference."""
        return self.trace.op_rng(self)
