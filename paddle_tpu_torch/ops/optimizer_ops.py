# ported from paddle_tpu/ops/optimizer_ops.py
"""Optimizer update ops of the training slices (reference:
``operators/optimizers/sgd_op.h``, ``adam_op.h``).

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

Left out against the JAX package: the mesh-sharded tables' branch and
``FLAGS_sparse_update_kernel`` (the wrappers pick kernel or plain version
by the tensors' device).
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
