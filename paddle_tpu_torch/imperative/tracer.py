# ported from paddle_tpu/imperative/tracer.py
"""Imperative (dygraph) engine: eager op dispatch on torch's autograd.

The reference's imperative mode routes every appended op through a C++
Tracer that executes it immediately and records grad-op nodes for a later
backward walk (reference: paddle/fluid/imperative/tracer.cc:102,
imperative/layer.h:113 VarBase / :285 OpBase). The JAX package records its
own tape and replays ``jax.vjp``; torch already records one, so here
``dispatch`` runs the *same registered op impls* the static Executor runs
(core/registry.py), eagerly on the tracer's device, and torch's autograd
is the tape: a :class:`VarBase` wraps a tensor, and ``backward`` is
``torch.autograd.backward``. What the JAX package's tape promises holds:

- gradients accumulate into leaves (parameters, ``to_variable`` inputs)
  across uses and across ``backward`` calls, until ``clear_gradient``;
- a second ``backward`` from the same loss adds the same gradients again
  and never compounds through intermediates (the graph is retained, and
  torch keeps no intermediate gradient).

Random draws (dropout, the initializers) come from the tracer's own
``torch.Generator`` on its device, seeded by ``guard(seed=...)``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import unique_name
from ..core.dtypes import convert_dtype, to_torch_dtype
from ..core.place import resolve_device
from ..core.registry import OpContext, get_op_impl

__all__ = ["VarBase", "Tracer", "dispatch", "trace_fn", "EagerBlock", "current_tracer"]

_TRACER_STACK: List["Tracer"] = []


def current_tracer() -> Optional["Tracer"]:
    return _TRACER_STACK[-1] if _TRACER_STACK else None


def _device():
    """The guard's device; outside ``guard()`` the card, as everywhere in
    the port (``RuntimeError`` without one): nothing runs on the CPU
    unless the caller asked for ``CPUPlace()``."""
    t = current_tracer()
    return t.device if t is not None else resolve_device(None)


def _as_tensor(value) -> torch.Tensor:
    """A tensor of ``value`` on the tracer's device (a tensor keeps its
    own device)."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.tensor(np.asarray(value)).to(_device())


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def assign_state(holder, new) -> None:
    """Write ``new`` into ``holder.value`` (a VarBase or an optimizer
    slot) in place when shape and dtype agree, so the tensor a CUDA graph
    captured keeps receiving the state; otherwise replace it."""
    old = getattr(holder, "value", None)
    if old is new:
        return
    if (isinstance(old, torch.Tensor) and old.shape == new.shape
            and old.dtype == new.dtype and old.device == new.device):
        with torch.no_grad():
            old.copy_(new)
    else:
        holder.value = new


class VarBase:
    """Eager variable: a tensor with the reference's ``VarBase`` surface
    (imperative/layer.h:113). A leaf (a parameter, a ``to_variable``
    input) holds its gradient in the tensor's ``.grad``; an op's output
    holds the op's autograd node."""

    def __init__(self, value, name: Optional[str] = None, stop_gradient: bool = False,
                 persistable: bool = False, trainable: bool = True,
                 is_parameter: bool = False):
        t = _as_tensor(value)
        self.name = name or unique_name.generate("tmp_var")
        self.persistable = persistable
        self.trainable = trainable
        self.is_parameter = is_parameter  # trainable-weight flag (vs BN stats etc.)
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self._value = t
        self._stop_gradient = True
        self.stop_gradient = stop_gradient

    # -- value and gradient ---------------------------------------------------
    @property
    def value(self) -> torch.Tensor:
        return self._value

    @value.setter
    def value(self, new):
        """Set a leaf's value: in place when the shape and dtype agree
        (a captured step reads the same tensor), else a new leaf."""
        new = _as_tensor(new).detach()
        old = self._value
        if (old.grad_fn is None and old.shape == new.shape
                and old.dtype == new.dtype and old.device == new.device):
            with torch.no_grad():
                old.copy_(new)
            return
        self._value = new
        self.stop_gradient = self._stop_gradient

    @property
    def stop_gradient(self) -> bool:
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, flag: bool):
        self._stop_gradient = bool(flag)
        t = self._value
        if t.grad_fn is None:
            if _is_float(t):
                t.requires_grad_(not flag)
        elif flag:
            self._value = t.detach()

    @property
    def _grad(self):
        return self._value.grad

    @_grad.setter
    def _grad(self, g):
        self._value.grad = g

    # -- reference VarBase surface -------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._value.shape)

    @property
    def dtype(self) -> str:
        return convert_dtype(self._value.dtype)

    def numpy(self) -> np.ndarray:
        return self._value.detach().cpu().numpy()

    _numpy = numpy  # reference 1.x spelling: var._numpy()

    def gradient(self) -> Optional[np.ndarray]:
        g = self._value.grad
        return None if g is None else g.detach().cpu().numpy()

    _gradient = gradient

    def backward(self):
        backward(self)

    _backward = backward

    def clear_gradient(self):
        self._value.grad = None

    def detach(self) -> "VarBase":
        return VarBase(self._value.detach(), name=self.name + ".detach",
                       stop_gradient=True)

    def astype(self, dtype) -> "VarBase":
        dt = to_torch_dtype(convert_dtype(dtype))
        return trace_fn(lambda x: x.to(dt), self)

    def __repr__(self):
        return "VarBase(name=%s, shape=%s, dtype=%s)" % (self.name, self.shape, self.dtype)

    def __len__(self):
        return int(self._value.shape[0])

    # -- math sugar (on the tape) ---------------------------------------------
    def _binop(self, other, fn):
        return trace_fn(fn, self, other)

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._binop(o, lambda a, b: b / a)

    def __pow__(self, o):
        return self._binop(o, lambda a, b: a ** b)

    def __matmul__(self, o):
        return self._binop(o, lambda a, b: a @ b)

    def __neg__(self):
        return trace_fn(lambda a: -a, self)

    def __getitem__(self, idx):
        return trace_fn(lambda a: a[idx], self)


def _wrap(t):
    if t is None:
        return None
    return VarBase(t, stop_gradient=not (isinstance(t, torch.Tensor)
                                         and t.requires_grad))


def _value_of(x):
    if isinstance(x, VarBase) or hasattr(x, "value"):
        return x.value
    if isinstance(x, (int, float, bool, torch.Tensor)):
        return x
    return _as_tensor(x)


def trace_fn(fn, *inputs, **kwargs):
    """Apply a torch function to VarBase / tensor / array inputs, eagerly,
    on the tape: the dygraph PyLayer primitive."""
    out = fn(*[_value_of(x) for x in inputs], **kwargs)
    if isinstance(out, (tuple, list)):
        return tuple(_wrap(o) for o in out)
    return _wrap(out)


class _EagerOp:
    """Minimal symbolic-op stand-in so registered impls run outside a
    Program (it keeps an op's constants, ``tensor_ops._cached``)."""

    def __init__(self, type_, inputs, outputs, attrs):
        self.type = type_
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = attrs
        self.block = None


class _EagerTrace:
    """The trace an eagerly run op sees: test mode, the tracer's device,
    and its generator (a fresh one seeded by the op's ``seed`` attr)."""

    program = None
    current_op_idx = 0
    both_branches = False

    def __init__(self, tracer: Optional["Tracer"], is_test: bool):
        self.tracer = tracer
        self.is_test = is_test
        self.device = _device()
        self.sparse_params = frozenset()
        self.sparse_rows = {}

    def op_rng(self, ctx):
        seed = ctx.attr("seed", 0)
        if seed or self.tracer is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
            return gen
        return self.tracer.next_rng()


def _flatten_slots(d: Optional[Dict[str, Any]], prefix: str):
    """slot→(value|list) dict → (op slot-name map, [(name, value)] pairs)."""
    slot_names: Dict[str, List[str]] = {}
    flat: List[Tuple[str, Any]] = []
    for slot, val in (d or {}).items():
        if val is None:
            continue
        vals = list(val) if isinstance(val, (list, tuple)) else [val]
        names = []
        for i, v in enumerate(vals):
            n = "__%s_%s_%d" % (prefix, slot, i)
            names.append(n)
            flat.append((n, v))
        slot_names[slot] = names
    return slot_names, flat


def dispatch(type_: str, inputs: Dict[str, Any], attrs: Optional[Dict[str, Any]] = None,
             out_slots: Sequence[str] = ("Out",), is_test: Optional[bool] = None):
    """Run a registered op eagerly with autograd.

    ``inputs`` maps slot → VarBase | tensor | array | list thereof (None
    skipped); returns one VarBase per out slot (single value if one slot).
    The imperative twin of the static interpreter's op step: same
    registry, same semantics, so every op of paddle_tpu_torch/ops/ runs in
    dygraph.
    """
    tracer = current_tracer()
    op_inputs, flat = _flatten_slots(inputs, "in")
    env = {n: _value_of(v) for n, v in flat}
    op = _EagerOp(type_, op_inputs, {s: ["__out_%s" % s] for s in out_slots},
                  dict(attrs or {}))
    if is_test is None:
        is_test = not (tracer.training if tracer else True)
    get_op_impl(type_)(OpContext(op, env, _EagerTrace(tracer, is_test)))
    outs = tuple(_wrap(env.get("__out_%s" % s)) for s in out_slots)
    return outs if len(out_slots) > 1 else outs[0]


def backward(loss: VarBase):
    """Reverse pass from ``loss`` (``torch.autograd.backward`` with the
    graph retained): leaves accumulate, intermediates hold nothing, so a
    second call adds the same gradients again."""
    if not loss.value.requires_grad:
        raise RuntimeError(
            "backward() on a variable with no recorded graph — did every "
            "input have stop_gradient=True?")
    torch.autograd.backward(loss.value, torch.ones_like(loss.value),
                            retain_graph=True)


class EagerBlock:
    """Block stand-in whose ``append_op`` executes immediately, in place.

    Used where static code appends state-mutating ops — parameter
    initializers and optimizer update ops. Inputs/outputs may be VarBase or
    any object with a ``.value`` tensor (optimizer accumulator slots);
    outputs are written back in place (:func:`assign_state`), with no
    autograd (these ops are leaves).
    """

    def append_op(self, type_, inputs=None, outputs=None, attrs=None):
        op_inputs, in_flat = _flatten_slots(inputs, "in")
        env = {n: _value_of(v) for n, v in in_flat}
        op_outputs, out_flat = _flatten_slots(outputs, "out")
        op = _EagerOp(type_, op_inputs, op_outputs, dict(attrs or {}))
        with torch.no_grad():
            get_op_impl(type_)(OpContext(op, env, _EagerTrace(
                current_tracer(), is_test=False)))
        for n, obj in out_flat:
            if n in env:
                assign_state(obj, env[n])
        return op


class Tracer:
    """Per-guard state: the device, the parameter registry, the random
    generator, train/eval mode."""

    def __init__(self, seed: int = 0, device=None):
        self.device = torch.device("cpu") if device is None else device
        self._params: Dict[str, VarBase] = {}
        self.seed = int(seed or 0)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.seed)
        self.training = True

    def next_rng(self) -> torch.Generator:
        """The generator the next random op draws from: the tracer's own,
        whose state moves on with every draw."""
        return self._gen

    def register_parameter(self, p: VarBase):
        self._params[p.name] = p

    def parameters(self) -> List[VarBase]:
        return list(self._params.values())

    def train_mode(self):
        self.training = True

    def eval_mode(self):
        self.training = False
