# ported from paddle_tpu/ops/nn_ops.py
"""NN ops: softmax, log-softmax, softmax with cross-entropy,
cross-entropy of probabilities, the elementwise losses, layer, batch,
group and instance norm, LRN, data norm, affine channel, 2-D and 3-D
convolution, transposed convolution and pooling, embedding (dense and
``is_sparse``), accuracy, AUC, mean IoU, bilinear and nearest
interpolation.

Fluid equivalents: ``operators/softmax_op.cc``,
``softmax_with_cross_entropy_op.cc``, ``cross_entropy_op.cc``,
``layer_norm_op.cc``, ``batch_norm_op.cc``, ``conv_op.cc``,
``conv_transpose_op.cc``, ``pool_op.cc``,
``lookup_table_op.cc``, ``metrics/accuracy_op.cc``, ``metrics/auc_op.cc``.

Convolution and pooling go to cuDNN and PyTorch's own pooling kernels
through ``F.conv{2,3}d``, ``F.conv_transpose{2,3}d`` and
``F.{max,avg}_pool{2,3}d``, and batch norm
is a ``torch.autograd.Function`` of torch reductions: the JAX package
computes them outside any Pallas kernel too (``conv_general_dilated``,
``reduce_window``, a ``custom_vjp`` of jnp reductions).

``softmax_with_cross_entropy`` with hard labels goes through the fused
softmax cross-entropy wrapper (:mod:`.kernels.softmax_xent`): the CUDA
kernel pair K2a/K2b for CUDA tensors, its plain version for CPU tensors.
The JAX package gates its Pallas kernel on TPU timings (V >= 4096; with
smoothing only V % 128 == 0, because the pad copy cost more than it saved
on a v5e). The CUDA kernels pad nothing, so every hard-label call takes
them; soft labels and a requested ``Softmax`` output stay composed, as in
the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtypes import to_torch_dtype
from ..core.registry import OpContext, register_op
from ..core.sparse import segment_sum
from .kernels.softmax_xent import softmax_xent
from .math_ops import _abs
from .tensor_ops import _cached


def _hard_labels(label):
    lbl = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 else label
    return lbl.long()


@register_op("softmax_with_cross_entropy")
def softmax_with_cross_entropy_op(ctx: OpContext):
    """One log_softmax pass serves plain CE, soft labels, AND label
    smoothing (``label_smoothing`` attr). The softmax runs in float32
    whatever the logits' dtype; the loss comes back in the logits' dtype."""
    logits = ctx.input("Logits")
    label = ctx.input("Label")
    soft_label = ctx.attr("soft_label", False)
    smooth = float(ctx.attr("label_smoothing", 0.0) or 0.0)
    ignore = int(ctx.attr("ignore_index", -100))
    out_dtype = logits.dtype
    if not soft_label and not ctx.has_output("Softmax"):
        lbl = _hard_labels(label)
        v = logits.shape[-1]
        loss = softmax_xent(logits.reshape(-1, v), lbl.reshape(-1),
                            smooth, ignore)
        ctx.set_output("Loss", loss.reshape(tuple(lbl.shape) + (1,))
                       .to(out_dtype))
        return
    log_p = torch.log_softmax(logits.float(), dim=-1)
    if soft_label:
        loss = -torch.sum(label * log_p, dim=-1, keepdim=True)
    else:
        lbl = _hard_labels(label)
        picked = torch.gather(log_p, -1, lbl.clamp(min=0)[..., None])
        loss = -picked
        if smooth:
            # q = (1-eps)·onehot + eps/K  ⇒  CE = (1-eps)·nll + eps/K·Σ(-logp)
            k = logits.shape[-1]
            loss = (1.0 - smooth) * loss + (smooth / k) * (
                -torch.sum(log_p, dim=-1, keepdim=True))
        loss = torch.where((lbl != ignore)[..., None], loss, 0.0)
    if ctx.has_output("Softmax"):
        ctx.set_output("Softmax", torch.exp(log_p).to(out_dtype))
    ctx.set_output("Loss", loss.to(out_dtype))


def _xent_from_probs(probs, label, soft_label, ignore_index=-100):
    if soft_label:
        return -torch.sum(label * torch.log(torch.clamp_min(probs, 1e-20)),
                          dim=-1, keepdim=True)
    lbl = _hard_labels(label)
    picked = torch.gather(probs, -1, lbl.clamp(min=0)[..., None])
    loss = -torch.log(torch.clamp_min(picked, 1e-20))
    return torch.where((lbl != ignore_index)[..., None], loss, 0.0)


@register_op("cross_entropy", "cross_entropy2")
def cross_entropy_op(ctx: OpContext):
    """Cross-entropy of probabilities (reference: operators/cross_entropy_op.cc):
    ``-log(max(p[label], 1e-20))`` for hard labels, 0 where the label is
    ``ignore_index``; ``-sum(label * log(max(p, 1e-20)))`` for soft ones. A
    plain torch composition: the default pass pipeline's
    ``softmax_xent_fuse_pass`` turns ``softmax`` + this op into
    ``softmax_with_cross_entropy`` (K2a/K2b on the card)."""
    ctx.set_output("Y", _xent_from_probs(
        ctx.input("X"), ctx.input("Label"), ctx.attr("soft_label", False),
        int(ctx.attr("ignore_index", -100))))


@register_op("layer_norm")
def layer_norm_op(ctx: OpContext):
    """Reference: operators/layer_norm_op.cc — normalize over dims >=
    begin_norm_axis, with the statistics in float32 (``F.layer_norm``
    upcasts a bf16 input internally)."""
    x = ctx.input("X")
    axis = ctx.attr("begin_norm_axis", 1)
    eps = ctx.attr("epsilon", 1e-5)
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    norm_shape = tuple(x.shape[axis:])
    y = F.layer_norm(
        x, norm_shape,
        None if scale is None else scale.to(x.dtype).reshape(norm_shape),
        None if bias is None else bias.to(x.dtype).reshape(norm_shape), eps)
    ctx.set_output("Y", y)
    if ctx.has_output("Mean") or ctx.has_output("Variance"):
        with torch.no_grad():
            var, mean = torch.var_mean(
                x.float(), dim=tuple(range(axis, x.dim())), unbiased=False)
        ctx.set_output("Mean", mean.reshape(-1))
        ctx.set_output("Variance", var.reshape(-1))


@register_op("softmax")
def softmax_op(ctx: OpContext):
    ctx.set_output("Out", torch.softmax(ctx.input("X"),
                                        dim=ctx.attr("axis", -1)))


@register_op("log_softmax")
def log_softmax_op(ctx: OpContext):
    ctx.set_output("Out", torch.log_softmax(ctx.input("X"),
                                            dim=ctx.attr("axis", -1)))


# -- elementwise losses -----------------------------------------------------
# Each is the JAX package's expression. At a kink torch's autograd takes
# the subgradient JAX's does: |x| branches on x >= 0 (1 at 0), a hinge is
# torch.maximum against 0 (half the gradient at the tie, as jnp.maximum).


def _relu_tie(x):
    """``jnp.maximum(x, 0)``: half the gradient at 0."""
    return torch.maximum(x, x.new_zeros(()))


@register_op("sigmoid_cross_entropy_with_logits")
def sigmoid_xent_op(ctx: OpContext):
    """max(x, 0) − x·z + log(1 + exp(−|x|)); 0 where the label is
    ``ignore_index``; ``normalize`` divides by the labels not ignored."""
    x, label = ctx.input("X"), ctx.input("Label")
    loss = _relu_tie(x) - x * label + torch.log1p(torch.exp(-_abs(x)))
    ignore = ctx.attr("ignore_index", -100)
    loss = torch.where(label == ignore, 0.0, loss)
    if ctx.attr("normalize", False):
        n = torch.clamp_min(torch.sum((label != ignore).to(x.dtype)), 1.0)
        loss = loss / n
    ctx.set_output("Out", loss)


@register_op("log_loss")
def log_loss_op(ctx: OpContext):
    p, y = ctx.input("Predicted"), ctx.input("Labels")
    eps = ctx.attr("epsilon", 1e-4)
    ctx.set_output("Loss", -y * torch.log(p + eps)
                   - (1 - y) * torch.log(1 - p + eps))


@register_op("huber_loss")
def huber_loss_op(ctx: OpContext):
    x, y = ctx.input("X"), ctx.input("Y")
    d = ctx.attr("delta", 1.0)
    r = y - x
    ar = _abs(r)
    ctx.set_output("Residual", r)
    ctx.set_output("Out", torch.where(ar <= d, 0.5 * r * r,
                                      d * (ar - 0.5 * d)))


@register_op("smooth_l1_loss")
def smooth_l1_loss_op(ctx: OpContext):
    x, y = ctx.input("X"), ctx.input("Y")
    s2 = ctx.attr("sigma", 1.0) ** 2
    diff = x - y
    if ctx.has_input("InsideWeight"):
        diff = diff * ctx.input("InsideWeight")
    ad = _abs(diff)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    if ctx.has_input("OutsideWeight"):
        loss = loss * ctx.input("OutsideWeight")
    ctx.set_output("Diff", diff)
    ctx.set_output("Out", torch.sum(loss, tuple(range(1, loss.dim())))
                   .reshape(x.shape[0], 1))


@register_op("hinge_loss")
def hinge_loss_op(ctx: OpContext):
    logits, labels = ctx.input("Logits"), ctx.input("Labels")
    ctx.set_output("Loss", _relu_tie(1.0 - (2.0 * labels - 1.0) * logits))


@register_op("rank_loss")
def rank_loss_op(ctx: OpContext):
    d = ctx.input("Left") - ctx.input("Right")
    ctx.set_output("Out", torch.log1p(torch.exp(d)) - ctx.input("Label") * d)


@register_op("bpr_loss")
def bpr_loss_op(ctx: OpContext):
    x = ctx.input("X")
    label = ctx.input("Label").reshape(-1).long()
    diff = x - torch.gather(x, -1, label[:, None])
    ctx.set_output("Y", torch.mean(torch.log1p(torch.exp(diff)), -1,
                                   keepdim=True))


@register_op("margin_rank_loss")
def margin_rank_loss_op(ctx: OpContext):
    label, x1, x2 = ctx.input("Label"), ctx.input("X1"), ctx.input("X2")
    out = _relu_tie(-label * (x1 - x2) + ctx.attr("margin", 0.0))
    ctx.set_output("Out", out)
    ctx.set_output("Activated", (out > 0).to(x1.dtype))


class _Lookup(torch.autograd.Function):
    """Rows of a table at ``ids`` (the dense lookup), whose backward is
    :func:`~paddle_tpu_torch.core.sparse.segment_sum`: the same bits in
    every run and on every stream."""

    @staticmethod
    def forward(ctx, w, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = w.shape[0]
        return F.embedding(ids, w)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return segment_sum(ids.reshape(-1), g.reshape(-1, g.shape[-1]),
                           ctx.num_rows), None


@register_op("lookup_table", "lookup_table_v2")
def lookup_table_op(ctx: OpContext):
    """Reference: operators/lookup_table_op.cc. Ids [..., 1] int → [..., D].

    Ids are clamped to the table for the gather; negative ids and
    ``padding_idx`` give zero rows. Dense mode is a gather differentiable
    in the table (:class:`_Lookup`: its backward sums repeated ids in the
    same order every run).

    ``is_sparse=True`` in a training step (the executor names the step's
    sparse tables in ``trace.sparse_params``) is the SelectedRows gradient
    path (core/sparse.py): the rows are gathered from the detached table
    and a zero "virtual rows" leaf [N, D] that requires grad is added to
    them, so the backward yields an O(N·D) rows gradient and no [V, D]
    gradient ever exists. The op registers (ids, leaf) under the table's
    name in ``trace.sparse_rows``; the ids facing the optimizer map ids
    < 0 (their output rows are zeroed, so their gradient rows are 0) to V,
    the merge padding id, so the row updates drop them instead of decaying
    row 0's moments. A ``padding_idx`` row keeps its id: its gradient row is
    0 and its moments decay lazily, as in the reference."""
    w = ctx.input("W")
    ids = ctx.input("Ids")
    if ids.dim() > 1 and ids.shape[-1] == 1 and ctx.op.type == "lookup_table":
        ids = ids.reshape(ids.shape[:-1])
    ids = ids.long()
    padding_idx = ctx.attr("padding_idx", -1)
    vocab, dim = w.shape
    w_name = ctx.op.inputs["W"][0]
    if ctx.attr("is_sparse", False) and w_name in getattr(
            ctx.trace, "sparse_params", ()):
        sparse_rows = ctx.trace.sparse_rows
        if w_name in sparse_rows:
            raise NotImplementedError(
                "sparse embedding table %r is looked up more than once in one "
                "program — use is_sparse=False for shared tables" % w_name)
        flat_raw = ids.reshape(-1)
        flat = flat_raw.clamp(0, vocab - 1)
        amp = getattr(ctx.trace.program, "_amp_dtype", None)
        vdt = to_torch_dtype(amp) if amp is not None \
            and w.dtype == torch.float32 else w.dtype
        virt = torch.zeros((flat.shape[0], dim), dtype=vdt, device=w.device,
                           requires_grad=True)
        sparse_rows[w_name] = (torch.where(flat_raw < 0, vocab, flat), virt)
        out = (w.detach()[flat].to(vdt) + virt).reshape(
            tuple(ids.shape) + (dim,))
    else:
        out = _Lookup.apply(w, ids.clamp(0, vocab - 1))
    keep = ids >= 0
    if padding_idx is not None and padding_idx >= 0:
        keep = keep & (ids != padding_idx)
    ctx.set_output("Out", torch.where(keep[..., None], out, 0.0))


@register_op("auc")
def auc_op(ctx: OpContext):
    """Streaming AUC via histogram stats (reference:
    operators/metrics/auc_op.cc). The persistable ``StatPos``/``StatNeg``
    histograms take this batch's 0/1 counts (``index_add``, exact in
    float32 below 2^24 per bucket) and are written back as
    ``StatPosOut``/``StatNegOut``."""
    preds = ctx.input("Predict")
    label = ctx.input("Label").reshape(-1)
    stat_pos, stat_neg = ctx.input("StatPos"), ctx.input("StatNeg")
    num_buckets = stat_pos.shape[-1]
    pos_prob = preds[:, 1] if preds.dim() == 2 and preds.shape[1] == 2 \
        else preds.reshape(-1)
    bucket = (pos_prob.detach() * num_buckets).long().clamp(
        0, num_buckets - 1)
    is_pos = (label > 0).to(stat_pos.dtype)
    new_pos = stat_pos.reshape(-1).index_add(0, bucket, is_pos)
    new_neg = stat_neg.reshape(-1).index_add(0, bucket, 1 - is_pos)
    # AUC = P(score_pos > score_neg): for each neg bucket, count positives in
    # strictly higher buckets plus half the same-bucket ties.
    tot_pos = new_pos.sum()
    pos_above = tot_pos - torch.cumsum(new_pos, 0)
    auc_sum = torch.sum(new_neg * (pos_above + new_pos * 0.5))
    tot_neg = new_neg.sum()
    pairs = tot_pos * tot_neg
    auc = torch.where(pairs > 0, auc_sum / pairs.clamp_min(1.0), 0.0)
    ctx.set_output("AUC", auc.float())
    ctx.set_output("StatPosOut", new_pos.reshape(stat_pos.shape))
    ctx.set_output("StatNegOut", new_neg.reshape(stat_neg.shape))


# -- normalization ----------------------------------------------------------


def _bn_shape(x, ch_axis):
    """The shape that broadcasts a per-channel vector against ``x``."""
    shape = [1] * x.dim()
    shape[ch_axis] = x.shape[ch_axis]
    return shape


def _bn_xhat(x, mean, inv, shape):
    """x̂ = (x − mean)·inv in x's dtype."""
    return (x - mean.to(x.dtype).reshape(shape)) \
        * inv.to(x.dtype).reshape(shape)


class _BatchNormTrain(torch.autograd.Function):
    """y = x̂·γ + β, x̂ = (x − mean)·inv, with the batch's ``mean`` and
    ``inv`` = rsqrt(var + eps) computed once by the op (they carry no
    gradient), and the closed-form backward of the JAX package's
    ``_bn_train_bwd``: dx = (γ·inv/N)·(N·dy − Σdy − x̂·Σ(dy·x̂)), the two
    sums accumulated in float32 off dy in x's dtype, the elementwise passes
    in x's dtype. Autograd through the statistics would carry float32
    cotangents of the whole activation instead."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean, inv, ch_axis):
        shape = _bn_shape(x, ch_axis)
        xhat = _bn_xhat(x, mean, inv, shape)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.ch_axis = ch_axis
        return xhat * scale.to(x.dtype).reshape(shape) \
            + bias.to(x.dtype).reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, inv = ctx.saved_tensors
        ch_axis = ctx.ch_axis
        shape = _bn_shape(x, ch_axis)
        axes = tuple(a for a in range(x.dim()) if a != ch_axis)
        n = x.numel() // x.shape[ch_axis]
        xhat = _bn_xhat(x, mean, inv, shape)
        dy_sum = torch.sum(dy, axes, dtype=torch.float32)
        dyxhat_sum = torch.sum(dy * xhat, axes, dtype=torch.float32)
        coef = (scale.float() * inv / n).to(x.dtype)
        dx = coef.reshape(shape) * (
            n * dy - dy_sum.to(x.dtype).reshape(shape)
            - xhat * dyxhat_sum.to(x.dtype).reshape(shape))
        return (dx, dyxhat_sum.to(scale.dtype), dy_sum.to(scale.dtype),
                None, None, None)


@register_op("batch_norm")
def batch_norm_op(ctx: OpContext):
    """Reference: operators/batch_norm_op.cc, NCHW or NHWC
    (``data_layout``).

    Training normalises by the batch's statistics, summed in float32
    straight off x (E[x²] − mean², the biased variance), and updates the
    running ones as Fluid does: ``MeanOut = momentum·Mean + (1 −
    momentum)·batch mean`` (momentum weighs the old value, the opposite of
    ``F.batch_norm``), ``VarianceOut`` likewise from the biased batch
    variance. ``is_test`` or ``use_global_stats`` normalises by the running
    statistics and returns them unchanged. The statistics outputs carry no
    gradient, so the executor writes plain tensors back to the scope."""
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    mean, var = ctx.input("Mean"), ctx.input("Variance")
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    ch_axis = 1 if ctx.attr("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    shape = _bn_shape(x, ch_axis)
    if ctx.attr("use_global_stats", False) or ctx.is_test:
        ctx.set_output("MeanOut", mean)
        ctx.set_output("VarianceOut", var)
        inv = torch.rsqrt(var.float() + eps).to(x.dtype)
        y = _bn_xhat(x, mean, inv, shape)
        ctx.set_output("Y", y * scale.to(x.dtype).reshape(shape)
                       + bias.to(x.dtype).reshape(shape))
        return
    axes = tuple(a for a in range(x.dim()) if a != ch_axis)
    n = x.numel() // x.shape[ch_axis]
    with torch.no_grad():
        bmean = torch.sum(x, axes, dtype=torch.float32) / n
        bvar = torch.sum(x.float().square(), axes) / n - bmean.square()
        inv = torch.rsqrt(bvar + eps)
        ctx.set_output("MeanOut", (momentum * mean.float()
                                   + (1 - momentum) * bmean).to(mean.dtype))
        ctx.set_output("VarianceOut", (momentum * var.float()
                                       + (1 - momentum) * bvar).to(var.dtype))
        ctx.set_output("SavedMean", bmean.to(mean.dtype))
        ctx.set_output("SavedVariance", bvar.to(var.dtype))
    ctx.set_output("Y", _BatchNormTrain.apply(x, scale, bias, bmean, inv,
                                              ch_axis))


def _var_mean(x, axes):
    """(biased variance, mean) over ``axes``, kept, as ``jnp.var`` /
    ``jnp.mean`` give them."""
    return torch.var_mean(x, axes, unbiased=False, keepdim=True)


@register_op("group_norm")
def group_norm_op(ctx: OpContext):
    """Reference: operators/group_norm_op.cc, NCHW: each sample's channels
    in ``groups`` groups, normalised over the group's channels and space;
    ``Mean``/``Variance`` [N, groups]."""
    x = ctx.input("X")
    groups = ctx.attr("groups")
    eps = ctx.attr("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    var, mean = _var_mean(xg, tuple(range(2, xg.dim())))
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    bshape = (1, c) + (1,) * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    ctx.set_output("Y", y)
    ctx.set_output("Mean", mean.reshape(n, groups))
    ctx.set_output("Variance", var.reshape(n, groups))


@register_op("instance_norm")
def instance_norm_op(ctx: OpContext):
    """Reference: operators/instance_norm_op.cc: each (sample, channel)
    normalised over space, then ``Scale``/``Bias`` per channel."""
    x = ctx.input("X")
    var, mean = _var_mean(x, tuple(range(2, x.dim())))
    y = (x - mean) * torch.rsqrt(var + ctx.attr("epsilon", 1e-5))
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    if scale is not None:
        bshape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
        y = y * scale.reshape(bshape) + bias.reshape(bshape)
    ctx.set_output("Y", y)


@register_op("lrn")
def lrn_op(ctx: OpContext):
    """Reference: operators/lrn_op.cc, NCHW: mid = k + α·Σ x² over the
    ``n`` channels around each (zero beyond the edges), out = x / mid^β."""
    x = ctx.input("X")
    n_size = ctx.attr("n", 5)
    half = n_size // 2
    sq = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    acc = torch.zeros_like(x)
    for i in range(n_size):
        acc = acc + sq[:, i:i + x.shape[1]]
    mid = ctx.attr("k", 2.0) + ctx.attr("alpha", 1e-4) * acc
    ctx.set_output("MidOut", mid)
    ctx.set_output("Out", x / torch.pow(mid, ctx.attr("beta", 0.75)))


@register_op("data_norm")
def data_norm_op(ctx: OpContext):
    """(x − mean)·scale from the running ``BatchSize``, ``BatchSum`` and
    ``BatchSquareSum`` (the JAX package's formula: scale =
    rsqrt(E[x²] − mean² + 1e-4))."""
    size = ctx.input("BatchSize")
    means = ctx.input("BatchSum") / size
    scales = torch.rsqrt(ctx.input("BatchSquareSum") / size
                         - torch.square(means) + 1e-4)
    ctx.set_output("Means", means)
    ctx.set_output("Scales", scales)
    ctx.set_output("Y", (ctx.input("X") - means) * scales)


@register_op("affine_channel")
def affine_channel_op(ctx: OpContext):
    x = ctx.input("X")
    ch = 1 if ctx.attr("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    shape = _bn_shape(x, ch)
    ctx.set_output("Out", x * ctx.input("Scale").reshape(shape)
                   + ctx.input("Bias").reshape(shape))


# -- conv / pool ------------------------------------------------------------


def _channels_first(x, last):
    """A channels-last (NHWC, NDHWC) tensor's channels-first view (which
    cuDNN takes as it is), or x itself."""
    return x.movedim(-1, 1) if last else x


def _channels_last(out, last):
    return out.movedim(1, -1) if last else out


_CONV = {(2, False): F.conv2d, (3, False): F.conv3d,
         (2, True): F.conv_transpose2d, (3, True): F.conv_transpose3d}


def _conv_nd(ctx: OpContext, nd: int, transpose: bool = False):
    """Reference: operators/conv_op.cc, conv_transpose_op.cc. Strides,
    symmetric paddings, dilations and groups; NCHW/NCDHW or channels last
    (``data_format``), the filter in Fluid's layout either way.

    A convolution's filter is [C_out, C_in/g, k...], a transposed one's
    [C_in, C_out/g, k...]: PyTorch's ``conv_transpose`` weight layout, so
    it is taken with no flip and no swap, for any ``groups``. Its output
    is (H−1)·s − 2p + d·(k−1) + 1 a spatial dim."""
    last = ctx.attr("data_format", "NCHW") in ("NHWC", "NDHWC")
    x = _channels_first(ctx.input("Input"), last)
    strides = tuple(ctx.attr("strides", [1] * nd))
    paddings = tuple(ctx.attr("paddings", [0] * nd))
    dilations = tuple(ctx.attr("dilations", [1] * nd))
    groups = ctx.attr("groups", 1) or 1
    conv = _CONV[(nd, transpose)]
    if transpose:
        out = conv(x, ctx.input("Filter"), None, strides, paddings, 0,
                   groups, dilations)
    else:
        out = conv(x, ctx.input("Filter"), None, strides, paddings,
                   dilations, groups)
    ctx.set_output("Output", _channels_last(out, last))


@register_op("conv2d", "depthwise_conv2d")
def conv2d_op(ctx: OpContext):
    _conv_nd(ctx, 2)


@register_op("conv3d")
def conv3d_op(ctx: OpContext):
    _conv_nd(ctx, 3)


@register_op("conv2d_transpose", "depthwise_conv2d_transpose")
def conv2d_transpose_op(ctx: OpContext):
    _conv_nd(ctx, 2, transpose=True)


@register_op("conv3d_transpose")
def conv3d_transpose_op(ctx: OpContext):
    _conv_nd(ctx, 3, transpose=True)


_POOL = {2: (F.max_pool2d, F.avg_pool2d, F.adaptive_max_pool2d,
             F.adaptive_avg_pool2d),
         3: (F.max_pool3d, F.avg_pool3d, F.adaptive_max_pool3d,
             F.adaptive_avg_pool3d)}


def _pool_nd(ctx: OpContext, nd: int):
    """Reference: operators/pool_op.cc, max or avg, channels first or last
    (``data_format``).

    ``global_pooling`` (or ``adaptive`` with ksize 1) reduces the whole
    volume; ``adaptive`` takes ksize as the output size, windows
    [floor(i·in/out), ceil((i+1)·in/out)) as in the JAX package. Padding
    is -inf for max; avg divides by the window (``exclusive`` false) or by
    the elements inside the input (``exclusive`` true). The JAX package
    never reads ``ceil_mode``, so neither does the port: windows always
    fit the padded input (floor mode)."""
    last = ctx.attr("data_format", "NCHW") in ("NHWC", "NDHWC")
    x = _channels_first(ctx.input("X"), last)
    max_pool, avg_pool, adaptive_max, adaptive_avg = _POOL[nd]
    is_max = ctx.attr("pooling_type", "max") == "max"
    ksize = [int(k) for k in ctx.attr("ksize", [1] * nd)]
    strides = [int(s) for s in ctx.attr("strides", [1] * nd)]
    pads = [int(p) for p in ctx.attr("paddings", [0] * nd)]
    exclusive = ctx.attr("exclusive", True) and any(pads)
    adaptive = ctx.attr("adaptive", False)
    spatial = tuple(range(2, 2 + nd))
    if ctx.attr("global_pooling", False) or (
            adaptive and all(k == 1 for k in ksize)):
        out = torch.amax(x, spatial, keepdim=True) if is_max \
            else torch.mean(x, spatial, keepdim=True)
    elif adaptive:
        out = (adaptive_max if is_max else adaptive_avg)(x, ksize)
    elif any(2 * p > k for p, k in zip(pads, ksize)):
        # torch pads at most half a window: pad explicitly
        pad = tuple(q for p in reversed(pads) for q in (p, p))
        if is_max:
            out = max_pool(F.pad(x, pad, value=-math.inf), ksize, strides)
        else:
            out = avg_pool(F.pad(x, pad), ksize, strides)
            if exclusive:
                ones = F.pad(torch.ones_like(x[:1, :1]), pad)
                out = out / avg_pool(ones, ksize, strides)
    elif is_max:
        out = max_pool(x, ksize, strides, pads)
    else:
        out = avg_pool(x, ksize, strides, pads,
                       count_include_pad=not exclusive)
    ctx.set_output("Out", _channels_last(out, last))


@register_op("pool2d")
def pool2d_op(ctx: OpContext):
    _pool_nd(ctx, 2)


@register_op("pool3d")
def pool3d_op(ctx: OpContext):
    _pool_nd(ctx, 3)


# -- metrics ----------------------------------------------------------------


@register_op("accuracy")
def accuracy_op(ctx: OpContext):
    """Reference: operators/metrics/accuracy_op.cc: a row is correct when
    its label is among its top-k ``Indices``. ``Accuracy`` float32,
    ``Correct`` and ``Total`` int32."""
    indices = ctx.input("Indices")
    lbl = ctx.input("Label").reshape(-1, 1)
    correct = torch.sum(torch.any(indices == lbl, dim=-1), dtype=torch.int32)
    total = lbl.shape[0]
    ctx.set_output("Accuracy", correct.float() / total)
    ctx.set_output("Correct", correct)
    # a fill on the device: a tensor made from the host scalar would be a
    # host-to-device copy every step, which a captured step cannot hold
    ctx.set_output("Total", torch.full((), total, dtype=torch.int32,
                                       device=indices.device))


@register_op("mean_iou")
def mean_iou_op(ctx: OpContext):
    """Mean over the classes present of intersection / union, from the
    confusion matrix of the flattened ``Labels`` and ``Predictions``. The
    counts are float32 sums of ones (exact below 2^24 a cell), so their
    order does not matter; nothing is read on the host."""
    preds = ctx.input("Predictions").reshape(-1).long()
    labels = ctx.input("Labels").reshape(-1).long()
    c = ctx.attr("num_classes")
    ones = torch.ones(preds.shape, dtype=torch.float32, device=preds.device)
    cm = torch.zeros(c * c, dtype=torch.float32, device=preds.device) \
        .index_put((labels * c + preds,), ones, accumulate=True).reshape(c, c)
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    valid = union > 0
    iou = torch.where(valid, inter / union.clamp_min(1.0), 0.0)
    ctx.set_output("OutMeanIou", iou.sum() / valid.sum().clamp_min(1))


# -- interpolation ----------------------------------------------------------


def _interp_weights(n_in, n_out, nearest, align_corners, align_mode):
    """The [n_out, n_in] float64 matrix of Fluid's interpolation along one
    dim (operators/interpolate_op.h). ratio = (in − 1)/(out − 1) with
    ``align_corners``, else in/out. Bilinear: the source is ratio·(k + ½)
    − ½ clamped at 0 when ``align_mode`` is 0 without corners (half-pixel
    centres), else ratio·k; it mixes its floor and the next index, the
    last clamped. Nearest: int(ratio·k + ½) with corners, int(ratio·k)
    without."""
    if align_corners:
        ratio = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    else:
        ratio = n_in / n_out
    w = np.zeros((n_out, n_in))
    for k in range(n_out):
        if nearest:
            w[k, min(int(ratio * k + 0.5) if align_corners
                     else int(ratio * k), n_in - 1)] = 1.0
            continue
        half = align_mode == 0 and not align_corners
        src = max(ratio * (k + 0.5) - 0.5, 0.0) if half else ratio * k
        lo = max(int(src), 0)
        hi = min(lo + 1, n_in - 1)
        d = src - lo
        w[k, lo] += 1.0 - d
        w[k, hi] += d
    return w


def _interp(ctx: OpContext, nearest: bool):
    """NCHW resize to (``out_h``, ``out_w``), or by ``scale``, or to the
    ``OutSize`` input (read on the host). It is Fluid's arithmetic as two
    products with the per-dim weight matrices (made once per shape and
    device, kept on the op), so its gradient has no atomics.
    ``align_corners`` / ``align_mode`` as in Fluid; where the op carries
    neither (the JAX package's layer writes neither), half-pixel centres:
    the JAX package's ``jax.image.resize``, which agrees with it up to
    antialiasing when shrinking (bilinear) and at fractional ratios
    (nearest, which the JAX package centres at half pixels)."""
    x = ctx.input("X")
    out_h, out_w = ctx.attr("out_h", 0), ctx.attr("out_w", 0)
    if ctx.has_input("OutSize"):
        out_h, out_w = (int(v) for v in ctx.input("OutSize").reshape(-1)
                        .tolist()[:2])
    scale = ctx.attr("scale", 0.0)
    if (not out_h or out_h <= 0) and scale:
        out_h, out_w = int(x.shape[2] * scale), int(x.shape[3] * scale)
    corners = ctx.attr("align_corners", False)
    mode = ctx.attr("align_mode", 0)
    key = (x.device, x.dtype, tuple(x.shape[2:]), out_h, out_w, corners,
           mode)
    wh, ww = _cached(ctx, key, lambda: tuple(
        torch.from_numpy(_interp_weights(n, m, nearest, corners, mode))
        .to(device=x.device, dtype=x.dtype)
        for n, m in ((x.shape[2], out_h), (x.shape[3], out_w))), slot=None)
    ctx.set_output("Out", torch.matmul(torch.matmul(wh, x), ww.t()))


@register_op("bilinear_interp")
def bilinear_interp_op(ctx):
    _interp(ctx, nearest=False)


@register_op("nearest_interp")
def nearest_interp_op(ctx):
    _interp(ctx, nearest=True)
