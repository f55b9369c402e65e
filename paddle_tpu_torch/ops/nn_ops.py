# ported from paddle_tpu/ops/nn_ops.py
"""NN ops of the training slices: softmax, softmax with cross-entropy,
cross-entropy of probabilities, layer norm, batch norm, 2-D and 3-D
convolution, transposed convolution and pooling, embedding (dense and
``is_sparse``), accuracy, AUC.

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

import torch
import torch.nn.functional as F

from ..core.dtypes import to_torch_dtype
from ..core.registry import OpContext, register_op
from .kernels.softmax_xent import softmax_xent


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


@register_op("lookup_table", "lookup_table_v2")
def lookup_table_op(ctx: OpContext):
    """Reference: operators/lookup_table_op.cc. Ids [..., 1] int → [..., D].

    Ids are clamped to the table for the gather; negative ids and
    ``padding_idx`` give zero rows. Dense mode is a gather differentiable
    in the table.

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
        out = F.embedding(ids.clamp(0, vocab - 1), w)
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
