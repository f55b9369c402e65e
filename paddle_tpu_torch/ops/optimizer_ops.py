# ported from paddle_tpu/ops/optimizer_ops.py
"""Optimizer update ops (reference: ``operators/optimizers/*_op.h``, and
``average_accumulates_op.cc`` for ``ModelAverage``).

The Executor runs these ops after the backward, under ``torch.no_grad()``.
The dense branches return new tensors, as the JAX package's do. Every
data-dependent choice (LARS's and LAMB's trust ratios, FTRL's
``|lin| > l1``, the model average's spill and window rollover) is a
``torch.where`` on the device: no op reads a device value on the host, so
a step with any of them captures into a CUDA graph.

A ``SparseGrad`` (an ``is_sparse`` embedding's gradient) takes the
SelectedRows branch of ``sgd``, ``adam``, ``momentum``, ``adagrad``,
``proximal_gd`` and ``proximal_adagrad``: the rows are merged
(``core.sparse.merge_rows``) and only the rows they name move, in place,
so no [V, D] tensor is made. Float32 tables under ``sgd`` and ``adam`` go
to the row kernels K4b/K4a (:mod:`.kernels.sparse_adam`); the other
branches, and tables of another dtype, are the JAX package's scatter
formulation in torch calls. The route depends on the dtype only, never on
the device: the kernel wrappers run their plain versions on CPU tensors.

Left out against the JAX package: the mesh-sharded tables' branch and
``FLAGS_sparse_update_kernel`` (the wrappers pick kernel or plain version
by the tensors' device). The ops the JAX package runs dense only
(``adamax``, ``decayed_adagrad``, ``adadelta``, ``rmsprop``, ``ftrl``,
``lamb``, ``lars_momentum``) raise on a ``SparseGrad``, naming the op.
"""

from __future__ import annotations

import torch

from ..core.registry import OpContext, register_op
from ..core.sparse import SparseGrad, merge_rows
from .kernels import sparse_adam as sa


def _lr(ctx):
    return ctx.input("LearningRate").reshape(())


def _dense(ctx, g):
    if isinstance(g, SparseGrad):
        raise NotImplementedError(
            "%s: an is_sparse table's gradient is not supported (the JAX "
            "package has no sparse branch either); use is_sparse=False"
            % ctx.op.type)
    return g


def _merged_rows(g, p):
    """The merged rows of ``g`` for table ``p``: (row index clamped into
    the table [N], mask of the real rows [N], summed rows [N, D] in p's
    dtype). The tail past the distinct ids is padding."""
    uniq, merged = merge_rows(g.ids, g.rows.to(p.dtype), p.shape[0])
    idx, valid = sa._gather_index(uniq, p.shape[0])
    return idx, valid, merged


def _set_rows(table, idx, valid, rows):
    """``table[ids] = rows`` for the real rows, in place. A padding row
    writes the last real row's index and value again, so every write to
    one index carries one value and the scatter is deterministic (the JAX
    package drops the padding's out-of-range writes)."""
    last = valid.sum() - 1
    src = torch.where(valid, torch.arange(idx.shape[0], device=idx.device),
                      last)
    table.index_put_((idx[src],), rows[src])
    return table


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
    lr = _lr(ctx).to(p.dtype)
    mu = ctx.attr("mu")
    if isinstance(g, SparseGrad):
        # lazy rows-only momentum: untouched rows keep their velocity, as
        # the reference's SelectedRows momentum does
        idx, valid, merged = _merged_rows(g, p)
        v_rows = mu * v[idx] + merged
        if ctx.attr("use_nesterov", False):
            step_rows = (merged + mu * v_rows) * lr
        else:
            step_rows = lr * v_rows
        _set_rows(p, idx, valid, p[idx] + (-step_rows))
        _set_rows(v, idx, valid, v_rows)
        ctx.set_output("ParamOut", p)
        ctx.set_output("VelocityOut", v)
        return
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
    g = _dense(ctx, g)
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


@register_op("adamw")
def adamw_op(ctx: OpContext):
    """Adam, then the decoupled decay p -= lr·coeff·p_old (the rate, not
    Adam's bias-corrected one), in float32."""
    p = ctx.input("Param")
    if isinstance(ctx.input("Grad"), SparseGrad):
        p = p.clone()  # the sparse Adam updates the table in place
    coeff = ctx.attr("weight_decay", 0.01)
    lr = _lr(ctx)
    adam_op(ctx)
    p_out = ctx.env[ctx.output_name("ParamOut")]
    ctx.set_output("ParamOut", (p_out.float() - lr * coeff * p.float())
                   .to(p.dtype))


@register_op("adamax")
def adamax_op(ctx: OpContext):
    p, g = ctx.input("Param"), _dense(ctx, ctx.input("Grad"))
    m, inf = ctx.input("Moment"), ctx.input("InfNorm")
    b1p = ctx.input("Beta1Pow")
    lr = _lr(ctx)
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf, torch.abs(g))
    lr_t = lr / (1 - b1p.reshape(()))
    ctx.set_output("ParamOut", p - lr_t * m_new / (inf_new + eps))
    ctx.set_output("MomentOut", m_new)
    ctx.set_output("InfNormOut", inf_new)
    ctx.set_output("Beta1PowOut", b1p * b1)


@register_op("adagrad")
def adagrad_op(ctx: OpContext):
    p, g, moment = ctx.input("Param"), ctx.input("Grad"), ctx.input("Moment")
    lr = _lr(ctx)
    eps = ctx.attr("epsilon", 1e-6)
    if isinstance(g, SparseGrad):
        idx, valid, merged = _merged_rows(g, p)
        m_rows = moment[idx] + torch.square(merged)
        _set_rows(p, idx, valid,
                  p[idx] + (-lr * merged / (torch.sqrt(m_rows) + eps)))
        _set_rows(moment, idx, valid, m_rows)
        ctx.set_output("ParamOut", p)
        ctx.set_output("MomentOut", moment)
        return
    m_new = moment + torch.square(g)
    ctx.set_output("ParamOut", p - lr * g / (torch.sqrt(m_new) + eps))
    ctx.set_output("MomentOut", m_new)


@register_op("decayed_adagrad")
def decayed_adagrad_op(ctx: OpContext):
    p, g = ctx.input("Param"), _dense(ctx, ctx.input("Grad"))
    moment = ctx.input("Moment")
    lr = _lr(ctx)
    decay = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    m_new = decay * moment + (1 - decay) * torch.square(g)
    ctx.set_output("ParamOut", p - lr * g / (torch.sqrt(m_new) + eps))
    ctx.set_output("MomentOut", m_new)


@register_op("adadelta")
def adadelta_op(ctx: OpContext):
    p, g = ctx.input("Param"), _dense(ctx, ctx.input("Grad"))
    avg_sq_g = ctx.input("AvgSquaredGrad")
    avg_sq_u = ctx.input("AvgSquaredUpdate")
    rho = ctx.attr("rho", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    g2 = rho * avg_sq_g + (1 - rho) * torch.square(g)
    update = -torch.sqrt((avg_sq_u + eps) / (g2 + eps)) * g
    u2 = rho * avg_sq_u + (1 - rho) * torch.square(update)
    ctx.set_output("ParamOut", p + update)
    ctx.set_output("AvgSquaredGradOut", g2)
    ctx.set_output("AvgSquaredUpdateOut", u2)


@register_op("rmsprop")
def rmsprop_op(ctx: OpContext):
    p, g = ctx.input("Param"), _dense(ctx, ctx.input("Grad"))
    ms, mom = ctx.input("MeanSquare"), ctx.input("Moment")
    lr = _lr(ctx)
    rho = ctx.attr("decay", 0.9)
    eps = ctx.attr("epsilon", 1e-10)
    mu = ctx.attr("momentum", 0.0)
    ms_new = rho * ms + (1 - rho) * torch.square(g)
    if ctx.attr("centered", False):
        mg = ctx.input("MeanGrad")
        mg_new = rho * mg + (1 - rho) * g
        mom_new = mu * mom + lr * g / torch.sqrt(
            ms_new - torch.square(mg_new) + eps)
        ctx.set_output("MeanGradOut", mg_new)
    else:
        mom_new = mu * mom + lr * g / torch.sqrt(ms_new + eps)
    ctx.set_output("ParamOut", p - mom_new)
    ctx.set_output("MeanSquareOut", ms_new)
    ctx.set_output("MomentOut", mom_new)


def _soft_threshold(prox, lr, l1, l2):
    """The proximal operator of proximal_gd/adagrad (reference:
    proximal_gd_op.h:49): the L1 soft threshold, then the L2 shrink. l1
    and l2 are attrs, so the branch is the host's."""
    if l1 > 0:
        return (torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1,
                                               min=0.0)
                / (1.0 + lr * l2))
    return prox / (1.0 + lr * l2)


@register_op("proximal_gd")
def proximal_gd_op(ctx: OpContext):
    p, g = ctx.input("Param"), ctx.input("Grad")
    lr = _lr(ctx).to(p.dtype)
    l1 = ctx.attr("l1", 0.0)
    l2 = ctx.attr("l2", 0.0)
    if isinstance(g, SparseGrad):
        idx, valid, merged = _merged_rows(g, p)
        prox_rows = p[idx] - lr * merged
        _set_rows(p, idx, valid, _soft_threshold(prox_rows, lr, l1, l2))
        ctx.set_output("ParamOut", p)
        return
    prox = p - lr * g.to(p.dtype)
    ctx.set_output("ParamOut", _soft_threshold(prox, lr, l1, l2))


@register_op("proximal_adagrad")
def proximal_adagrad_op(ctx: OpContext):
    p, g, moment = ctx.input("Param"), ctx.input("Grad"), ctx.input("Moment")
    lr = _lr(ctx).to(p.dtype)
    l1 = ctx.attr("l1", 0.0)
    l2 = ctx.attr("l2", 0.0)
    if isinstance(g, SparseGrad):
        idx, valid, merged = _merged_rows(g, p)
        m_rows = moment[idx] + torch.square(merged)
        prox_rows = p[idx] - lr * merged / torch.sqrt(m_rows)
        _set_rows(p, idx, valid, _soft_threshold(prox_rows, lr, l1, l2))
        _set_rows(moment, idx, valid, m_rows)
        ctx.set_output("ParamOut", p)
        ctx.set_output("MomentOut", moment)
        return
    g = g.to(p.dtype)
    m_new = moment + torch.square(g)
    prox = p - lr * g / torch.sqrt(m_new)
    ctx.set_output("ParamOut", _soft_threshold(prox, lr, l1, l2))
    ctx.set_output("MomentOut", m_new)


@register_op("ftrl")
def ftrl_op(ctx: OpContext):
    """FTRL-proximal (reference: ftrl_op.h); the power branch is the
    ``lr_power`` attr's, the ``|lin| > l1`` choice a ``torch.where``."""
    p, g = ctx.input("Param"), _dense(ctx, ctx.input("Grad"))
    sq_accum = ctx.input("SquaredAccumulator")
    lin_accum = ctx.input("LinearAccumulator")
    lr = _lr(ctx)
    l1 = ctx.attr("l1", 0.0)
    l2 = ctx.attr("l2", 0.0)
    lr_power = ctx.attr("lr_power", -0.5)
    new_accum = sq_accum + torch.square(g)
    if lr_power == -0.5:
        lin_new = lin_accum + g - (torch.sqrt(new_accum)
                                   - torch.sqrt(sq_accum)) / lr * p
        y = torch.sqrt(new_accum) / lr + 2 * l2
    else:
        lin_new = lin_accum + g - (torch.pow(new_accum, -lr_power)
                                   - torch.pow(sq_accum, -lr_power)) / lr * p
        y = torch.pow(new_accum, -lr_power) / lr + 2 * l2
    x = l1 * torch.sign(lin_new) - lin_new
    p_new = torch.where(torch.abs(lin_new) > l1, x / y, torch.zeros_like(p))
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("SquaredAccumOut", new_accum)
    ctx.set_output("LinearAccumOut", lin_new)


@register_op("lamb")
def lamb_op(ctx: OpContext):
    """LAMB (You et al. 2019): Adam's bias-corrected direction plus
    ``weight_decay``·p, scaled by the trust ratio ‖p‖/‖update‖ where both
    are positive (else 1), chosen on the device."""
    p, g = ctx.input("Param"), _dense(ctx, ctx.input("Grad"))
    m, v = ctx.input("Moment1"), ctx.input("Moment2")
    b1p, b2p = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    lr = _lr(ctx)
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-6)
    wd = ctx.attr("weight_decay", 0.01)
    gf = g.float()
    pf = p.float()
    m_new = b1 * m + (1 - b1) * gf
    v_new = b2 * v + (1 - b2) * torch.square(gf)
    m_hat = m_new / (1 - b1p.reshape(()))
    v_hat = v_new / (1 - b2p.reshape(()))
    update = m_hat / (torch.sqrt(v_hat) + eps) + wd * pf
    w_norm = torch.sqrt(torch.sum(torch.square(pf)))
    u_norm = torch.sqrt(torch.sum(torch.square(update)))
    ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm, 1.0)
    ctx.set_output("ParamOut", (pf - lr * ratio * update).to(p.dtype))
    ctx.set_output("Moment1Out", m_new)
    ctx.set_output("Moment2Out", v_new)
    ctx.set_output("Beta1PowOut", b1p * b1)
    ctx.set_output("Beta2PowOut", b2p * b2)


# reference kMaxNumAccumulates: sum_1 spills into sum_2 every this many
# updates, so no float32 running sum grows past its precision
MAX_NUM_ACCUMULATES = 16384


@register_op("average_accumulates")
def average_accumulates_op(ctx: OpContext):
    """The running sums behind ``ModelAverage`` (reference:
    operators/average_accumulates_op.h; the JAX package's
    ``ops/extra_ops.py``): sum_1 += param; every ``MAX_NUM_ACCUMULATES``
    updates sum_1 spills into sum_2; once the window holds at least
    ``min_average_window`` and ``min(max_average_window, updates ·
    average_window)`` accumulates, sum_1 + sum_2 become sum_3 and the
    window starts again. The counters are int64 [1] tensors (int32 in the
    JAX package's 32-bit mode); both choices are ``torch.where``s on them."""
    param = ctx.input("Param")
    sum1, sum2, sum3 = (ctx.input("InSum1"), ctx.input("InSum2"),
                        ctx.input("InSum3"))
    num_acc = ctx.input("InNumAccumulates").reshape(())
    old_num = ctx.input("InOldNumAccumulates").reshape(())
    num_upd = ctx.input("InNumUpdates").reshape(())
    avg_window = float(ctx.attr("average_window", 0.0))
    max_avg = int(ctx.attr("max_average_window", 10000))
    min_avg = int(ctx.attr("min_average_window", 10000))

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    sum1 = sum1 + param
    spill = num_upd % MAX_NUM_ACCUMULATES == 0
    sum2 = torch.where(spill, sum2 + sum1, sum2)
    sum1 = torch.where(spill, torch.zeros_like(sum1), sum1)
    window = torch.clamp((num_upd.float() * avg_window).to(num_upd.dtype),
                         max=max_avg)
    roll = (num_acc >= min_avg) & (num_acc >= window)
    sum3 = torch.where(roll, sum1 + sum2, sum3)
    sum1 = torch.where(roll, torch.zeros_like(sum1), sum1)
    sum2 = torch.where(roll, torch.zeros_like(sum2), sum2)
    old_num = torch.where(roll, num_acc, old_num)
    num_acc = torch.where(roll, torch.zeros_like(num_acc), num_acc)

    ctx.set_output("OutSum1", sum1)
    ctx.set_output("OutSum2", sum2)
    ctx.set_output("OutSum3", sum3)
    ctx.set_output("OutNumAccumulates", num_acc.reshape(1))
    ctx.set_output("OutOldNumAccumulates", old_num.reshape(1))
    ctx.set_output("OutNumUpdates", num_upd.reshape(1))
