# ported from paddle_tpu/contrib/int8_inference/calibrator.py
"""Post-training int8 calibration — quantize a TRAINED fp32 program without
any retraining (reference: contrib/int8_inference/utility.py Calibrator;
its KL algorithm follows the classic 8-bit-inference entropy calibration).

Flow (mirrors the reference's sample → optimal scales → rewritten program):

1. ``sample_data(feed)``: run the fp32 inference program over calibration
   batches, observing every ACTIVATION that feeds a quantizable op
   (conv2d/depthwise_conv2d/mul/matmul) — accumulating abs-max and, for the
   KL algorithm, a fixed-range histogram per var.
2. ``calibrate()``: compute per-activation scales (``abs_max`` or ``KL``
   entropy-optimal thresholds), then reuse the existing QAT machinery:
   transpile quant/dequant pairs into a clone of the program
   (``range_abs_max`` activations read their frozen InScale in test mode),
   write the calibrated scales into the scope, and ``freeze_program`` —
   weights land on the int8 grid from their own abs-max, activations use
   the calibrated scales.

Sampling fetches through the port's executor (on its device; each
activation copied to the host once a batch), the histograms are numpy on
the host as in the JAX package (calibration is offline), the calibrated
scales go into the scope as tensors on the executor's device, and the
emitted program is the same simulated-int8 form the QAT freeze produces.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...core.framework import Parameter, Program
from ...core.scope import global_scope, scope_guard
from ..quantize.quantize_transpiler import (
    _QUANTIZABLE_OP_TYPES,
    QuantizeTranspiler,
    _scale_name,
)

__all__ = ["Calibrator"]

_HIST_BINS = 2048


class Calibrator:
    """reference: contrib/int8_inference/utility.py:25."""

    def __init__(self, program: Program, exe, feed_names: Sequence[str] = (),
                 fetch_list=None, scope=None, algo: str = "KL",
                 weight_bits: int = 8, activation_bits: int = 8):
        if algo not in ("KL", "abs_max"):
            raise ValueError("algo must be 'KL' or 'abs_max', got %r" % algo)
        self.program = program
        self.exe = exe
        self.scope = scope or global_scope()
        # constructor feed_names/fetch_list become save_int8_model defaults
        # (reference Calibrator carries them the same way)
        self._default_feed_names = list(feed_names or ())
        self._default_fetch_list = list(fetch_list or ())
        self.algo = algo
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self._act_names = self._quantizable_activations(program)
        self._abs_max: Dict[str, float] = {n: 0.0 for n in self._act_names}
        self._hist: Dict[str, np.ndarray] = {
            n: np.zeros(_HIST_BINS, np.float64) for n in self._act_names}
        self._hist_range: Dict[str, float] = {}
        self._sampled = 0

    @staticmethod
    def _quantizable_activations(program) -> List[str]:
        params = {p.name for b in program.blocks for p in b.vars.values()
                  if isinstance(p, Parameter)}
        acts = []
        for block in program.blocks:
            for op in block.ops:
                if op.type in _QUANTIZABLE_OP_TYPES:
                    for name in op.input_arg_names:
                        if name not in params and name not in acts:
                            acts.append(name)
        return acts

    # -- phase 1: sampling ----------------------------------------------------
    def sample_data(self, feed):
        """One calibration batch: observe every quantizable activation."""
        vals = self.exe.run(self.program, feed=feed,
                            fetch_list=list(self._act_names),
                            scope=self.scope, return_numpy=True)
        for name, v in zip(self._act_names, vals):
            amax = float(np.max(np.abs(v))) if v.size else 0.0
            self._abs_max[name] = max(self._abs_max[name], amax)
            if self.algo == "KL":
                # first batch fixes the histogram range; later batches that
                # overflow it clip into the last bin (same approximation as
                # the reference's fixed sampling range)
                r = self._hist_range.setdefault(name, max(amax, 1e-8))
                # clip so later-batch overflow folds into the edge bin —
                # np.histogram would silently DROP out-of-range values and
                # the KL search would see an artificially light tail
                h, _ = np.histogram(np.minimum(np.abs(v), r),
                                    bins=_HIST_BINS, range=(0, r))
                self._hist[name] += h
        self._sampled += 1

    # -- phase 2: scales + program rewrite ------------------------------------
    def _scales(self) -> Dict[str, float]:
        if self.algo == "abs_max":
            return dict(self._abs_max)
        out = {}
        for n in self._act_names:
            r = self._hist_range.get(n, 1e-8)
            out[n] = _kl_threshold(self._hist[n], r,
                                   bits=self.activation_bits)
            # never clip below what a pure abs-max would within the range
            out[n] = min(max(out[n], 1e-8), max(self._abs_max[n], 1e-8))
        return out

    def calibrate(self, startup_program: Optional[Program] = None) -> Program:
        """Emit the quantized inference program (simulated-int8 form)."""
        if self._sampled == 0:
            raise RuntimeError("Calibrator: call sample_data() on at least "
                               "one batch before calibrate()")
        qprog = self.program.clone()
        startup = startup_program or Program()
        t = QuantizeTranspiler(
            weight_bits=self.weight_bits,
            activation_bits=self.activation_bits,
            activation_quantize_type="range_abs_max",
            weight_quantize_type="abs_max")
        t.training_transpile(qprog, startup)
        # run the quant-state initializers, then overwrite the activation
        # scales with the calibrated values (order matters: startup would
        # reset them to the 0.001 placeholder)
        self.exe.run(startup, scope=self.scope)
        device = getattr(self.exe, "place", None)
        for name, scale in self._scales().items():
            self.scope.set_var(_scale_name(name), torch.tensor(
                [scale], dtype=torch.float32, device=device))
        t.freeze_program(qprog, scope=self.scope)
        self._quant_prog = qprog
        return qprog

    def save_int8_model(self, dirname: str, feed_names: Sequence[str] = None,
                        fetch_vars=None) -> None:
        """Calibrate (if needed) and save the deployable int8 model
        (reference: Calibrator.save_int8_model). ``feed_names``/``fetch_vars``
        default to the constructor's feed_names/fetch_list."""
        from ... import io as fluid_io
        from ..quantize.quantize_transpiler import QuantizeTranspiler as _QT

        feed_names = self._default_feed_names if feed_names is None else feed_names
        fetch_vars = self._default_fetch_list if fetch_vars is None else fetch_vars
        if not feed_names or not fetch_vars:
            raise ValueError(
                "save_int8_model needs feed_names and fetch_vars (pass them "
                "here or to the Calibrator constructor)")
        prog = getattr(self, "_quant_prog", None) or self.calibrate()
        t = _QT(weight_bits=self.weight_bits,
                activation_bits=self.activation_bits)
        t.convert_to_int8(prog, scope=self.scope)
        with scope_guard(self.scope):
            fluid_io.save_inference_model(dirname, list(feed_names),
                                          list(fetch_vars), self.exe,
                                          main_program=prog)


def _kl_threshold(hist: np.ndarray, hist_range: float, bits: int = 8) -> float:
    """Entropy-optimal clip threshold over an |x| histogram.

    For each candidate threshold i (from 128 bins up), compare the reference
    distribution P (hist clipped at i, outliers folded into the edge bin)
    with its (2^(bits-1)) -level quantized reconstruction Q; pick the i
    minimizing KL(P||Q). Vectorized numpy — calibration is offline host
    work, no need to jit."""
    nbins = hist.size
    levels = 1 << (bits - 1)  # 128 for int8
    total = hist.sum()
    if total == 0:
        return hist_range
    best_i, best_kl = nbins, np.inf
    for i in range(levels, nbins + 1, 16):
        raw = hist[:i].astype(np.float64)
        p = raw.copy()
        p[i - 1] += hist[i:].sum()  # fold outliers into the clip bin
        if p.sum() == 0:
            continue
        # quantize the RAW clipped histogram (no outlier fold — that's what
        # penalizes aggressive clipping): merge i bins into `levels` groups,
        # redistribute uniformly over the nonzero source bins of each group
        factor = i / float(levels)
        edges = (np.arange(levels + 1) * factor).astype(np.int64)
        q = np.zeros(i, np.float64)
        for g in range(levels):
            lo, hi = edges[g], max(edges[g + 1], edges[g] + 1)
            seg = raw[lo:hi]
            nz = seg > 0
            if nz.any():
                q[lo:hi][nz] = seg.sum() / nz.sum()
        pn = p / p.sum()
        qn = q / max(q.sum(), 1e-12)
        mask = pn > 0
        kl = float(np.sum(pn[mask] * np.log(pn[mask] /
                                            np.maximum(qn[mask], 1e-12))))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return hist_range * best_i / nbins
