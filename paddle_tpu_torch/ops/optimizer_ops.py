# ported from paddle_tpu/ops/optimizer_ops.py
"""Optimizer update ops of the training slice (reference:
``operators/optimizers/adam_op.h``).

Only the dense branch of ``adam`` is ported. The Executor runs these ops
after the backward, under ``torch.no_grad()``; like the JAX package's they
return new tensors rather than updating in place. The sparse (SelectedRows)
branch and its row kernels (K4a/K4b) come with the CTR slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.registry import OpContext, register_op


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float: torch then multiplies a
    float32 tensor by exactly the float32 constant the JAX package uses."""
    return float(np.float32(x))


def _lr(ctx):
    return ctx.input("LearningRate").reshape(())


@register_op("adam")
def adam_op(ctx: OpContext):
    p, g = ctx.input("Param"), ctx.input("Grad")
    m, v = ctx.input("Moment1"), ctx.input("Moment2")
    b1p, b2p = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    beta1, beta2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    b1, b2 = _f32(beta1), _f32(beta2)
    omb1 = float(np.float32(1) - np.float32(beta1))
    omb2 = float(np.float32(1) - np.float32(beta2))
    eps = _f32(ctx.attr("epsilon", 1e-8))
    # Reference adam_op.h: lr_t = lr * sqrt(1-beta2^t)/(1-beta1^t), eps
    # outside the sqrt
    lr_t = _lr(ctx) * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    gf = g.float()
    m_new = m * b1 + gf * omb1
    v_new = v * b2 + gf.square() * omb2
    p_new = p.float() - lr_t * m_new / (v_new.sqrt() + eps)
    ctx.set_output("ParamOut", p_new.to(p.dtype))
    ctx.set_output("Moment1Out", m_new)
    ctx.set_output("Moment2Out", v_new)
    # Fluid updates beta pows in a separate scale op; the outs are set too
    # where a program wires them
    if ctx.has_output("Beta1PowOut"):
        ctx.set_output("Beta1PowOut", b1p * b1)
    if ctx.has_output("Beta2PowOut"):
        ctx.set_output("Beta2PowOut", b2p * b2)
