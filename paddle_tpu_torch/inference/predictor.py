# ported from paddle_tpu/inference/predictor.py
"""Inference predictor API.

Reference: ``PaddlePredictor``/``CreatePaddlePredictor``
(``inference/api/paddle_api.h:186,314``) and ``AnalysisPredictor``
(``api/analysis_predictor.cc:183,337``). The reference loads a ProgramDesc,
runs an IR-pass fusion pipeline, and executes with NaiveExecutor. The JAX
package jit-compiles the loaded program whole, one compile a feed shape.
Here the saved program desc is loaded with ``io.load_inference_model`` and
each run is the port's captured step (``CompiledProgram`` through
:class:`~..executor.Executor`): on the card one CUDA graph a feed shape,
captured after two eager warm-ups and replayed; on the CPU the same
step's static body. The IR options are accepted and change nothing.

The desc carries no AMP mode, so a loaded model runs in float32 (as in
the JAX package).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.scope import Scope, scope_guard

__all__ = ["AnalysisConfig", "Predictor", "create_predictor"]


class AnalysisConfig:
    """reference: inference/api/paddle_analysis_config.h:34. The card is
    the default (``use_gpu()`` is true); ``disable_gpu()`` asks for the
    CPU."""

    def __init__(self, model_dir: Optional[str] = None,
                 prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self._use_gpu = True
        self._device_id = 0
        self._ir_optim = True  # accepted; the captured step fuses nothing
        self._memory_optim = True
        # Round batch sizes up to power-of-two buckets, as the JAX package
        # does by default: each feed shape is one captured step (its
        # warm-ups, its graph and the graph's memory pool), so a
        # varying-batch client makes O(log max_batch) of them instead of
        # one per batch size. Outputs are sliced back to the true batch.
        self._batch_bucketing = True

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True
        self._device_id = int(device_id)

    # a script written for the JAX package names its accelerator the TPU
    enable_use_tpu = enable_use_gpu

    def disable_gpu(self):
        self._use_gpu = False

    def switch_ir_optim(self, x: bool = True):
        self._ir_optim = x

    def enable_memory_optim(self, x: bool = True):
        self._memory_optim = x

    def switch_batch_bucketing(self, x: bool = True):
        """Opt out (``switch_batch_bucketing(False)``) to capture a step
        per exact batch size, e.g. when a fixed-batch client wants no
        padding."""
        self._batch_bucketing = bool(x)

    def batch_bucketing(self) -> bool:
        return self._batch_bucketing

    def use_gpu(self) -> bool:
        return self._use_gpu

    def gpu_device_id(self) -> int:
        return self._device_id


class _IOHandle:
    """Zero-copy-style tensor handle (reference: ZeroCopyTensor)."""

    def __init__(self, name: str, owner: "Predictor", is_input: bool):
        self.name = name
        self._owner = owner
        self._is_input = is_input

    def copy_from_cpu(self, arr: np.ndarray):
        arr = np.asarray(arr)
        want = self._owner._declared_shapes.get(self.name)
        if want is not None and tuple(arr.shape) != want:
            raise ValueError(
                "input %r staged with shape %s but reshape() declared %s"
                % (self.name, tuple(arr.shape), want))
        self._owner._staged_inputs[self.name] = arr

    def reshape(self, shape):
        """Declare the input's shape (reference ZeroCopyTensor::Reshape).
        Validated against the staged array — a mismatch raises instead of
        silently running with whatever was staged."""
        if not self._is_input:
            raise ValueError("reshape() is only valid on input handles")
        want = tuple(int(s) for s in shape)
        staged = self._owner._staged_inputs.get(self.name)
        if staged is not None and tuple(staged.shape) != want:
            raise ValueError(
                "reshape(%s) conflicts with already-staged array of shape %s "
                "for input %r" % (want, tuple(staged.shape), self.name))
        self._owner._declared_shapes[self.name] = want

    def copy_to_cpu(self) -> np.ndarray:
        return np.asarray(self._owner._last_outputs[self.name])


class Predictor:
    """Runs a saved inference model on ``config``'s device: the card
    ``gpu_device_id()`` (``RuntimeError`` where PyTorch sees no GPU), or the
    CPU after ``config.disable_gpu()``."""

    def __init__(self, config: AnalysisConfig):
        from .. import io as io_mod
        from ..compiler import CompiledProgram
        from ..core.place import CPUPlace, CUDAPlace
        from ..executor import Executor

        self.config = config
        self._scope = Scope()
        place = CUDAPlace(config.gpu_device_id()) if config.use_gpu() \
            else CPUPlace()
        self._exe = Executor(place)
        with scope_guard(self._scope):
            self._program, self._feed_names, self._fetch_names = (
                io_mod.load_inference_model(
                    config.model_dir, self._exe,
                    model_filename=config.prog_file,
                    params_filename=config.params_file))
        self._compiled = CompiledProgram(self._program)
        self._staged_inputs: Dict[str, np.ndarray] = {}
        self._declared_shapes: Dict[str, tuple] = {}
        self._last_outputs: Dict[str, np.ndarray] = {}

    # -- modern handle API ----------------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def get_input_handle(self, name: str) -> _IOHandle:
        return _IOHandle(name, self, True)

    def get_output_handle(self, name: str) -> _IOHandle:
        return _IOHandle(name, self, False)

    # -- execution ------------------------------------------------------------
    def run(self, inputs: Optional[Sequence[np.ndarray]] = None):
        """run([x1, x2, ...]) positional over feed names, or run() after
        staging via input handles. Returns outputs (numpy) in fetch order.

        Each run is the captured step at its feed shapes. With batch
        bucketing on (the default; ``AnalysisConfig.
        switch_batch_bucketing(False)`` opts out), the leading dim is
        padded up to the next power of two before the step and sliced back
        after, bounding the captured steps to O(log max_batch) for a
        varying-batch client. Models with a batch-reducing fetch fall back
        to an exact-shape run (the reduction over padded rows would be
        wrong);
        the one undetectable edge is an output whose NON-batch leading dim
        coincidentally equals the padded batch while every other output is
        per-row — opt out of bucketing for such models."""
        if inputs is not None:
            feed = {n: np.asarray(a) for n, a in zip(self._feed_names, inputs)}
        else:
            feed = dict(self._staged_inputs)
            # staged inputs are consumed by the run (ZeroCopyTensor
            # semantics): the next iteration stages fresh arrays, and a new
            # reshape()/copy_from_cpu pair never collides with this one's
            self._staged_inputs.clear()
            self._declared_shapes.clear()
        exact_feed = dict(feed) if self.config.batch_bucketing() else None
        batch = self._bucket_batch(feed) if exact_feed is not None else None
        with scope_guard(self._scope):
            outs = self._exe.run(self._compiled, feed=feed,
                                 fetch_list=self._fetch_names)
            if batch is not None:
                real, padded = batch
                if all(getattr(o, "shape", ()) and o.shape[0] == padded
                       for o in outs):
                    # every fetch is per-row: drop the padding rows
                    outs = [o[:real] for o in outs]
                else:
                    # some fetch reduced over (or reshaped away) the batch
                    # dim — its value over the padded rows would be WRONG,
                    # and there is no way to un-reduce it. Re-run at the
                    # exact batch.
                    outs = self._exe.run(self._compiled, feed=exact_feed,
                                         fetch_list=self._fetch_names)
        self._last_outputs = dict(zip(self._fetch_names, outs))
        return outs

    @staticmethod
    def _bucket_batch(feed):
        """Pad every feed's leading dim up to the next power of two, in
        place; returns (real_batch, padded_batch) or None when the feeds
        don't share a positive leading dim (nothing to bucket). Padding
        repeats the last row (edge mode) so models with log/div ops never
        see synthetic zeros."""
        dims = {int(v.shape[0]) for v in feed.values()
                if getattr(v, "ndim", 0) >= 1}
        if len(dims) != 1:
            return None
        real = dims.pop()
        if real < 1 or any(getattr(v, "ndim", 0) < 1 for v in feed.values()):
            return None
        padded = 1
        while padded < real:
            padded *= 2
        if padded == real:
            return None
        for n, v in feed.items():
            feed[n] = np.pad(v, [(0, padded - real)] + [(0, 0)] * (v.ndim - 1),
                             mode="edge")
        return real, padded


def create_predictor(config: AnalysisConfig) -> Predictor:
    """reference: CreatePaddlePredictor (paddle_api.h:314)."""
    return Predictor(config)
