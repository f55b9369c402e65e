# ported from paddle_tpu/amp.py
"""Automatic mixed precision.

The reference's half-precision story is the software ``float16`` type
(``platform/float16.h``) + fp16 kernels selected per-op, with contrib loss
scaling. Here the half type is **bfloat16**, which the card's tensor cores
multiply natively: it has float32's exponent range, so no loss scaling is
required. The fp32→bf16 policy is applied by the executor: forward and
backward compute in bf16 against fp32 master weights, the optimizer updates
in fp32. fp16 is also accepted (needs loss scaling).

API:
    fluid.amp.enable(program)                    # bf16 forward for program
    opt = fluid.amp.decorate(optimizer, ...)     # + static loss scaling
"""

from __future__ import annotations

from typing import Optional

from .core.framework import Program, default_main_program

__all__ = ["enable", "disable", "decorate", "OptimizerWithMixedPrecision"]


def enable(program: Optional[Program] = None, dtype: str = "bfloat16"):
    """Run this program's forward/backward in ``dtype`` with fp32 master
    weights and fp32 optimizer math."""
    program = program or default_main_program()
    if dtype not in ("bfloat16", "float16"):
        raise ValueError("amp dtype must be bfloat16 or float16, got %r" % dtype)
    program._amp_dtype = dtype
    program._version += 1
    return program


def disable(program: Optional[Program] = None):
    program = program or default_main_program()
    program._amp_dtype = None
    program._version += 1
    return program


class OptimizerWithMixedPrecision:
    """reference: contrib/mixed_precision decorate() — scales the loss before
    backward and unscales gradients before the update. With bf16 the scale
    defaults to 1.0 (not needed); set it for fp16."""

    def __init__(self, optimizer, amp_dtype="bfloat16", init_loss_scaling=1.0,
                 use_dynamic_loss_scaling=False):
        if use_dynamic_loss_scaling:
            raise NotImplementedError(
                "dynamic loss scaling is unnecessary for bf16 (the default); "
                "use static init_loss_scaling for fp16")
        self._optimizer = optimizer
        self._amp_dtype = amp_dtype
        self._scale = float(init_loss_scaling)

    def __getattr__(self, name):
        return getattr(self._optimizer, name)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from . import layers
        from .core.framework import program_guard

        program = loss.block.program
        enable(program, self._amp_dtype)
        with program_guard(program, startup_program):
            if self._scale != 1.0:
                scaled = layers.scale(loss, scale=self._scale)
            else:
                scaled = loss
            params_grads = self._optimizer.backward(
                scaled, startup_program, parameter_list, no_grad_set)
            if self._scale != 1.0:
                block = program.global_block
                for _, g in params_grads:
                    block.append_op("scale", inputs={"X": g}, outputs={"Out": g},
                                    attrs={"scale": 1.0 / self._scale})
            optimize_ops = self._optimizer.apply_gradients(params_grads)
        return optimize_ops, params_grads


def decorate(optimizer, amp_dtype="bfloat16", init_loss_scaling=1.0,
             use_dynamic_loss_scaling=False):
    return OptimizerWithMixedPrecision(
        optimizer, amp_dtype, init_loss_scaling, use_dynamic_loss_scaling)
