# ported from paddle_tpu/ops/optimizer_ops.py
"""Optimizer update ops of the training slices (reference:
``operators/optimizers/sgd_op.h``, ``momentum_op.h``,
``lars_momentum_op.h``, ``adam_op.h``).

The Executor runs these ops after the backward, under ``torch.no_grad()``.
The dense branches return new tensors, as the JAX package's do. A
``SparseGrad`` (an ``is_sparse`` embedding's gradient) takes the
SelectedRows branch: the rows are merged (``core.sparse.merge_rows``) and
only the rows they name move. Float32 tables go to the row kernels K4a/K4b
(:mod:`.kernels.sparse_adam`), which update them in place; tables of
another dtype go to the same scatter formulation, the kernels' plain
version, as in the JAX package. The route depends on the dtype only,
never on the device: the kernel wrappers run their plain versions on CPU
tensors.

Left out against the JAX package: the mesh-sharded tables' branch,
``FLAGS_sparse_update_kernel`` (the wrappers pick kernel or plain version
by the tensors' device) and the sparse branch of ``momentum`` (it raises).
"""

from __future__ import annotations

import torch

from ..core.registry import OpContext, register_op
from ..core.sparse import SparseGrad, merge_rows
from .kernels import sparse_adam as sa


def _lr(ctx):
    return ctx.input("LearningRate").reshape(())


@register_op("sgd")
def sgd_op(ctx: OpContext):
    p, g = ctx.input("Param"), ctx.input("Grad")
    lr = _lr(ctx).to(p.dtype)
    if isinstance(g, SparseGrad):
        # SelectedRows branch (reference: sgd_op.h sparse path): only the
        # looked-up rows move, duplicate ids summed first
        uniq, merged = merge_rows(g.ids, g.rows.to(p.dtype), p.shape[0])
        if sa.sparse_rows_supported(p):
            sa.sparse_sgd_rows(p, uniq, merged, lr)
        else:
            sa.sparse_sgd_rows_reference(p, uniq, merged, lr)
        ctx.set_output("ParamOut", p)
        return
    ctx.set_output("ParamOut", p - lr * g.to(p.dtype))


@register_op("momentum")
def momentum_op(ctx: OpContext):
    """Dense momentum: v = mu·v + g, then p -= lr·v, or with
    ``use_nesterov`` p -= (g + mu·v)·lr, in the parameter's dtype."""
    p, g, v = ctx.input("Param"), ctx.input("Grad"), ctx.input("Velocity")
    if isinstance(g, SparseGrad):
        raise NotImplementedError(
            "momentum: the sparse (is_sparse table) gradient branch is not "
            "ported; use Adam or SGD for is_sparse tables")
    lr = _lr(ctx).to(p.dtype)
    mu = ctx.attr("mu")
    g = g.to(p.dtype)
    v_new = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("VelocityOut", v_new)


@register_op("lars_momentum")
def lars_momentum_op(ctx: OpContext):
    """Layer-wise adaptive rate (reference: lars_momentum_op.h): local_lr =
    lr·coeff·‖p‖ / (‖g‖ + decay·‖p‖) where both norms are positive, else
    lr; v = mu·v + local_lr·(g + decay·p); p -= v. The norms and the choice
    stay on the device: no host read, so the step captures."""
    p, g, v = ctx.input("Param"), ctx.input("Grad"), ctx.input("Velocity")
    if isinstance(g, SparseGrad):
        raise NotImplementedError(
            "lars_momentum: an is_sparse table's gradient is not supported; "
            "use is_sparse=False")
    lr = _lr(ctx).to(p.dtype)
    mu = ctx.attr("mu")
    coeff = ctx.attr("lars_coeff", 0.001)
    decay = ctx.attr("lars_weight_decay", 0.0005)
    g = g.to(p.dtype)
    pn = torch.sqrt(torch.sum(torch.square(p)))
    gn = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = torch.where((pn > 0) & (gn > 0),
                           lr * coeff * pn / (gn + decay * pn), lr)
    v_new = mu * v + local_lr * (g + decay * p)
    ctx.set_output("ParamOut", p - v_new)
    ctx.set_output("VelocityOut", v_new)


@register_op("adam")
def adam_op(ctx: OpContext):
    p, g = ctx.input("Param"), ctx.input("Grad")
    m, v = ctx.input("Moment1"), ctx.input("Moment2")
    b1p, b2p = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    beta1, beta2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    epsilon = ctx.attr("epsilon", 1e-8)
    b1, omb1, b2, omb2, eps = sa.adam_constants(beta1, beta2, epsilon)
    # Reference adam_op.h: lr_t = lr * sqrt(1-beta2^t)/(1-beta1^t), eps
    # outside the sqrt; it stays on the device
    lr_t = _lr(ctx) * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    # Fluid updates beta pows in a separate scale op; the outs are set too
    # where a program wires them
    if ctx.has_output("Beta1PowOut"):
        ctx.set_output("Beta1PowOut", b1p * b1)
    if ctx.has_output("Beta2PowOut"):
        ctx.set_output("Beta2PowOut", b2p * b2)
    if isinstance(g, SparseGrad):
        # lazy-mode sparse adam (reference: adam_op.h SelectedRows branch,
        # lazy_mode): moments decay and params move ONLY on touched rows
        uniq, merged = merge_rows(g.ids, g.rows.float(), p.shape[0])
        update = sa.sparse_adam_rows if sa.sparse_rows_supported(p, m, v) \
            else sa.sparse_adam_rows_reference
        update(p, m, v, uniq, merged, lr_t.float(), beta1, beta2, epsilon)
        ctx.set_output("ParamOut", p)
        ctx.set_output("Moment1Out", m)
        ctx.set_output("Moment2Out", v)
        return
    gf = g.float()
    m_new = m * b1 + gf * omb1
    v_new = v * b2 + gf.square() * omb2
    p_new = p.float() - lr_t * m_new / (v_new.sqrt() + eps)
    ctx.set_output("ParamOut", p_new.to(p.dtype))
    ctx.set_output("Moment1Out", m_new)
    ctx.set_output("Moment2Out", v_new)
