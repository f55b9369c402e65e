# ported from paddle_tpu/inference/export.py
"""Self-contained inference artifacts through ``torch.export``.

The JAX package's ``export_stablehlo``/``load_stablehlo`` serialize XLA's
own IR, so those names stay JAX's. What they do carries over: the pruned
feed→fetch function of a program becomes one artifact, with the params
baked in and the batch dimension symbolic, that runs without the graph
builder (reference: ``save_inference_model`` io.py:863 + the C++ predictor
loading it). Here that function is the executor's eager ``for_test`` step
(the default pass pipeline's clone for the fetch set, then the
interpreter's ops), traced by ``torch.export.export`` with the scope's
persistable tensors as the exported program's constants and, for
``batch_polymorphic``, one symbolic ``Dim`` on dimension 0 of every feed,
and saved by ``torch.export.save`` to ``__program__.pt2`` beside the JAX
package's meta JSON (feed and fetch names).

The export runs on the device the scope's tensors lie on. A hand-written
CUDA kernel is a ``ctypes`` call ``torch.export`` cannot trace: on the
card a step that reaches one raises ``ops.kernels._build.ExportRefused``
naming the kernel, and never takes the kernel's plain version in its
place (``_build.refuse_export``). On the CPU every wrapper runs its plain
version, as it always does there. Making the kernels ``torch.library``
custom ops, so an export can hold them, is open work (ROADMAP).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["export_program", "load_program"]

_ARTIFACT = "__program__.pt2"
_META = "__program_meta__.json"


class _Step(torch.nn.Module):
    """The ``for_test`` step of ``program`` as a module: the persistable
    state as tensors it holds (no parameters or buffers, so the export
    lifts them as constants), the feeds as positional arguments in
    ``feed_names`` order, the fetches as a tuple in ``fetch_names``
    order."""

    def __init__(self, program, plan, state, feed_names, fetch_names, device):
        super().__init__()
        self._program = program
        self._plan = plan
        self._state = state
        self._feed_names = list(feed_names)
        self._fetch_names = list(fetch_names)
        self._device = device

    def forward(self, *feeds):
        from ..core.interpreter import run_block_ops
        from ..executor import (TraceContext, _feed_dtype, _forward_done,
                                _forward_env)

        block = self._program.global_block
        state = dict(self._state)
        fed = {}
        for n, v in zip(self._feed_names, feeds):
            dtype = _feed_dtype(block, n)
            fed[n] = v if dtype is None else v.to(dtype)
        env, before = _forward_env(self._plan, state, fed)
        trace = TraceContext(self._program, True, self._device, 0)
        with torch.no_grad():
            run_block_ops(self._plan.ops, env, trace)
        _forward_done(self._plan, state, env, before)
        return tuple(env[n] for n in self._fetch_names)


def export_program(
    dirname: str,
    feed_names: Sequence[str],
    fetch_names: Sequence[str],
    example_feeds: Dict[str, np.ndarray],
    program=None,
    scope=None,
    batch_polymorphic: bool = True,
):
    """Export the program's feed→fetch function as a ``torch.export``
    artifact (``__program__.pt2``) in ``dirname``; returns its path.

    The params are baked into the artifact as constants. With
    ``batch_polymorphic`` dimension 0 of every feed is one symbolic size,
    so any batch runs without a re-export; else the artifact takes the
    example feeds' shapes only. ``example_feeds`` give the shapes and
    dtypes the trace runs on. Raises ``ExportRefused`` when the step
    reaches a hand-written CUDA kernel (module docstring)."""
    from ..core.framework import Variable, default_main_program
    from ..core.scope import global_scope
    from ..executor import _Plan
    from ..ops.kernels import _build
    from ..passes.pipeline import maybe_optimize

    feed_names = list(feed_names)
    fetch_names = [f.name if isinstance(f, Variable) else str(f)
                   for f in fetch_names]
    scope = scope if scope is not None else global_scope()
    program = (program or default_main_program()).clone(for_test=True)
    program = maybe_optimize(program, tuple(fetch_names), scope)
    plan = _Plan(program, True)
    state = {}
    for n in plan.state_names:
        val = scope.find_var(n)
        if val is not None:
            state[n] = torch.as_tensor(val)
    devices = {t.device for t in state.values()}
    if len(devices) > 1:
        raise ValueError("export_program: the scope's tensors lie on %s; "
                         "they must share one device" % sorted(map(str, devices)))
    device = devices.pop() if devices else torch.device("cpu")
    module = _Step(program, plan, state, feed_names, fetch_names, device)
    args = tuple(torch.as_tensor(np.asarray(example_feeds[n])).to(device)
                 for n in feed_names)
    dynamic = None
    if batch_polymorphic:
        batch = torch.export.Dim("batch")
        dynamic = (tuple({0: batch} for _ in args),)  # the *feeds tuple
    with _build.exporting():
        try:
            exported = torch.export.export(module, args,
                                           dynamic_shapes=dynamic)
        except Exception as e:  # the interpreter wraps an op's error
            refused = _cause(e, _build.ExportRefused)
            if refused is None:
                raise
            raise _build.ExportRefused(str(refused)) from e
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, _ARTIFACT)
    torch.export.save(exported, path)
    with open(os.path.join(dirname, _META), "w") as f:
        json.dump({"feed_names": feed_names, "fetch_names": fetch_names}, f)
    return path


def _cause(exc, kind):
    """The first exception of type ``kind`` in ``exc``'s chain of causes,
    or None."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        if isinstance(exc, kind):
            return exc
        seen.add(id(exc))
        exc = exc.__cause__ or exc.__context__
    return None


class _LoadedModule:
    """A loaded artifact: :meth:`run` takes a feed dict and returns the
    fetches as numpy arrays, in the saved fetch order."""

    def __init__(self, exported, feed_names, fetch_names):
        self._exported = exported
        self.feed_names = feed_names
        self.fetch_names = fetch_names
        self._module = exported.module()
        self.device = next((t.device for t in exported.constants.values()
                            if isinstance(t, torch.Tensor)),
                           torch.device("cpu"))

    def run(self, feed: Dict[str, object]):
        """The fetches of ``feed`` (arrays or tensors, by feed name)."""
        args = [torch.as_tensor(feed[n]).to(self.device)
                for n in self.feed_names]
        with torch.no_grad():
            return [t.cpu().numpy() for t in self._module(*args)]


def load_program(dirname: str) -> _LoadedModule:
    """Load an artifact of :func:`export_program`."""
    exported = torch.export.load(os.path.join(dirname, _ARTIFACT))
    with open(os.path.join(dirname, _META)) as f:
        meta = json.load(f)
    return _LoadedModule(exported, meta["feed_names"], meta["fetch_names"])
