# ported from paddle_tpu/ops/nn_ops.py
"""NN ops of the training slice: softmax with cross-entropy, layer norm,
embedding.

Fluid equivalents: ``operators/softmax_with_cross_entropy_op.cc``,
``layer_norm_op.cc``, ``lookup_table_op.cc``.

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

import torch
import torch.nn.functional as F

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


@register_op("lookup_table", "lookup_table_v2")
def lookup_table_op(ctx: OpContext):
    """Reference: operators/lookup_table_op.cc. Ids [..., 1] int → [..., D].

    Dense gather, differentiable in the table. Ids are clamped to the table
    for the gather; negative ids and ``padding_idx`` give zero rows. The
    sparse (``is_sparse``) gradient path of the JAX package is not ported
    yet: the table's gradient here is dense."""
    w = ctx.input("W")
    ids = ctx.input("Ids")
    if ids.dim() > 1 and ids.shape[-1] == 1 and ctx.op.type == "lookup_table":
        ids = ids.reshape(ids.shape[:-1])
    ids = ids.long()
    padding_idx = ctx.attr("padding_idx", -1)
    out = F.embedding(ids.clamp(0, w.shape[0] - 1), w)
    keep = ids >= 0
    if padding_idx is not None and padding_idx >= 0:
        keep = keep & (ids != padding_idx)
    ctx.set_output("Out", torch.where(keep[..., None], out, 0.0))
