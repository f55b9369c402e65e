# ported from paddle_tpu/testing/op_test.py
"""Per-op test harness (reference: tests/unittests/op_test.py:133 — the
workhorse behind the reference's 334 per-op test files).

The same contract, on torch:

- ``check_output``: run the registered op impl on concrete inputs on a
  ``place`` (the card by default, ``CPUPlace()`` for the CPU) and compare
  against expected numpy outputs; the reference runs the real kernel on
  every available place, so one test runs on the CPU and on the card by
  its ``place`` alone.
- ``check_grad``: compare ``torch.autograd`` of sum(output) against
  central finite differences, both in float64 (every floating input is
  cast to float64 first), on the ``place``. The reference compares its
  hand-written grad op against finite differences; here autograd replaces
  the grad op, and the check validates that the impl is differentiable
  and smooth where it is evaluated.

An op reads its attrs, test mode and random stream as the executor hands
them over (``executor.TraceContext``; the generator seeded from ``seed``,
step 0 and the op's position 0).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.framework import Operator, Program
from ..core.place import resolve_device
from ..core.registry import OpContext, get_op_impl
from ..core.sparse import SparseGrad

__all__ = ["run_op", "check_output", "check_grad", "OpTest"]

InputSpec = Union[np.ndarray, List[Tuple[str, np.ndarray]]]


def _canon_inputs(inputs: Dict[str, InputSpec], device):
    """Normalize {slot: array | [(name, array), ...]} → (slot_map, env) with
    every value a tensor on ``device``."""
    slot_map: Dict[str, List[str]] = {}
    env: Dict[str, Any] = {}

    def as_value(v):
        if isinstance(v, SparseGrad):  # sparse-optimizer variants under test
            return SparseGrad(ids=torch.as_tensor(v.ids).to(device),
                              rows=torch.as_tensor(v.rows).to(device))
        return torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v).to(device)

    for slot, spec in (inputs or {}).items():
        if isinstance(spec, list) and spec and isinstance(spec[0], tuple):
            names = []
            for name, arr in spec:
                env[name] = as_value(arr)
                names.append(name)
            slot_map[slot] = names
        else:
            name = "%s@in" % slot
            env[name] = as_value(spec)
            slot_map[slot] = [name]
    return slot_map, env


def _op(op_type, slot_map, out_map, attrs, seed):
    prog = Program()
    prog.random_seed = seed
    op = Operator(prog.global_block, op_type, attrs=attrs)
    op.inputs = slot_map
    op.outputs = out_map
    return prog, op


def _run(prog, op, env, is_test, device):
    from ..executor import TraceContext

    get_op_impl(op.type)(OpContext(op, env, TraceContext(
        prog, is_test, device, 0)))


def run_op(
    op_type: str,
    inputs: Dict[str, InputSpec],
    output_slots: Sequence[str],
    attrs: Optional[Dict[str, Any]] = None,
    is_test: bool = False,
    seed: int = 0,
    place=None,
) -> Dict[str, Any]:
    """Execute one registered op on ``place`` (the card when None); returns
    {output_slot: tensor}."""
    device = resolve_device(place)
    slot_map, env = _canon_inputs(inputs, device)
    out_map = {slot: ["%s@out" % slot] for slot in output_slots}
    prog, op = _op(op_type, slot_map, out_map, attrs, seed)
    with torch.no_grad():
        _run(prog, op, env, is_test, device)
    return {slot: env.get(out_map[slot][0]) for slot in output_slots}


def _numpy(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def check_output(
    op_type: str,
    inputs: Dict[str, InputSpec],
    expected: Dict[str, np.ndarray],
    attrs: Optional[Dict[str, Any]] = None,
    atol: float = 1e-5,
    rtol: float = 1e-5,
    is_test: bool = False,
    place=None,
):
    got = run_op(op_type, inputs, list(expected), attrs, is_test=is_test,
                 place=place)
    for slot, want in expected.items():
        np.testing.assert_allclose(
            _numpy(got[slot]), want, atol=atol, rtol=rtol,
            err_msg="op %r output slot %r mismatch" % (op_type, slot))


def check_grad(
    op_type: str,
    inputs: Dict[str, InputSpec],
    inputs_to_check: Sequence[str],
    output_slot: str,
    attrs: Optional[Dict[str, Any]] = None,
    max_relative_error: float = 5e-3,
    delta: float = 1e-3,
    seed: int = 0,
    place=None,
):
    """Autograd-vs-finite-difference check in float64 (reference:
    op_test.py:418) on ``place`` (the card when None)."""
    device = resolve_device(place)
    slot_map, env0 = _canon_inputs(inputs, device)
    env0 = {n: v.double() if isinstance(v, torch.Tensor)
            and v.is_floating_point() else v for n, v in env0.items()}
    out_map = {output_slot: ["%s@out" % output_slot]}
    prog, op = _op(op_type, slot_map, out_map, attrs, seed)

    check_names = []
    for slot in inputs_to_check:
        check_names.extend(slot_map[slot])

    def f(check_env):
        env = dict(env0)
        env.update(check_env)
        _run(prog, op, env, False, device)
        return torch.sum(env[out_map[output_slot][0]].double())

    leaves = {n: env0[n].clone().requires_grad_(True) for n in check_names}
    with torch.enable_grad():
        grads = torch.autograd.grad(f(leaves), [leaves[n] for n in check_names],
                                    allow_unused=True)
    analytic = {n: torch.zeros_like(env0[n]) if g is None else g
                for n, g in zip(check_names, grads)}

    for name in check_names:
        base = env0[name]
        flat = base.reshape(-1)
        num = torch.empty(flat.numel(), dtype=torch.float64, device=device)
        with torch.no_grad():
            for i in range(flat.numel()):
                plus, minus = flat.clone(), flat.clone()
                plus[i] += delta
                minus[i] -= delta
                num[i] = (f({name: plus.reshape(base.shape)})
                          - f({name: minus.reshape(base.shape)})) / (2 * delta)
        num = _numpy(num).reshape(base.shape)
        a = _numpy(analytic[name]).astype(np.float64)
        abs_err = np.abs(a - num)
        denom = np.maximum(np.maximum(np.abs(a), np.abs(num)), 1.0)
        rel = (abs_err / denom).max()
        assert rel <= max_relative_error, (
            "op %r grad wrt %r: max relative error %.3e > %.3e\nanalytic=%s\nnumeric=%s"
            % (op_type, name, rel, max_relative_error, a, num))


class OpTest:
    """Class-style harness for familiarity with the reference's OpTest.

    Subclass sets ``op_type``, ``inputs``, ``attrs``, ``outputs`` in setup and
    calls ``self.check_output(place=...)`` / ``self.check_grad([...], 'Out',
    place=...)``.
    """

    op_type: str = ""
    inputs: Dict[str, InputSpec] = {}
    attrs: Dict[str, Any] = {}
    outputs: Dict[str, np.ndarray] = {}

    def check_output(self, atol=1e-5, rtol=1e-5, is_test=False, place=None):
        check_output(self.op_type, self.inputs, self.outputs, self.attrs,
                     atol=atol, rtol=rtol, is_test=is_test, place=place)

    def check_grad(self, inputs_to_check, output_slot="Out",
                   max_relative_error=5e-3, delta=1e-3, place=None):
        check_grad(self.op_type, self.inputs, inputs_to_check, output_slot,
                   self.attrs, max_relative_error, delta, place=place)
