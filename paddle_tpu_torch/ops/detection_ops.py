# ported from paddle_tpu/ops/detection_ops.py
"""Detection ops (reference: paddle/fluid/operators/detection/ —
prior_box_op.cc, box_coder_op.cc, iou_similarity_op.cc,
bipartite_match_op.cc, target_assign_op.cc, multiclass_nms_op.cc,
anchor_generator_op.cc, box_clip_op.cc, density_prior_box_op.cc,
yolov3_loss_op.cc, generate_proposals_op.cc, mine_hard_examples_op.cc,
polygon_box_transform_op.cc, rpn_target_assign_op.cc,
generate_proposal_labels_op.cc, generate_mask_labels_op.cc,
roi_perspective_transform_op.cc; roi_align_op.cc / roi_pool_op.cc and
detection_map_op.cc in operators/).

The JAX package's conventions, kept as they are:

- Variable-length results (NMS keeps, proposals) are padded: fixed
  ``[B, K, ...]`` outputs padded with -1 plus a ``Length`` [B] count.
- Ground truth is dense ``[B, Ng, ...]``; a box of zero area (w or h
  <= 0) is a padding row.
- The documented deviations from Fluid: two samples a bin in
  ``roi_align`` when ``sampling_ratio`` <= 0, and ``detection_map``
  refusing ``evaluate_difficult=False``.

What the port adds to hold the JAX semantics on the card:

- **Order.** Every sort and top-k is :func:`_desc_order`: a stable sort
  of the scores' total-order integer keys, so equal scores keep the lower
  index first, as ``jnp.argsort`` (stable) and ``jax.lax.top_k`` do,
  on every device (``torch.topk`` promises nothing about ties on CUDA).
- **Loops on the device.** The greedy loops (bipartite matching, NMS and
  its ``eta`` decay) are Python loops of a fixed count over tensors of
  the whole batch: no host read, so a CUDA graph captures them. NMS over
  K candidates is K steps of ~4 kernels.
- **Gathers by data** are clamped, as JAX clamps them (an out-of-range
  CUDA gather is a device assert), and a one-hot of a padding label is a
  comparison with ``arange``, a zero row as ``jax.nn.one_hot`` gives.
- **Deterministic backwards.** The differentiable gathers (``roi_align``'s
  and ``roi_perspective_transform``'s bilinear taps, ``roi_pool``'s
  feature rows, ``yolov3_loss``'s assigned cells) read rows of a
  channels-last table through ``nn_ops._Lookup``, whose backward is
  ``core.sparse.segment_sum``: the same bits on every run and stream.
- **Constants** made from attrs (priors, anchors, variances) are built
  once per op and device (``tensor_ops._cached``): a captured step holds
  no host-to-device copy.
- ``detection_map`` is the one host op (``executor.HOST_OPS``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.registry import OpContext, register_op
from .nn_ops import _Lookup
from .tensor_ops import _cached

_INF = float("inf")

# -- order --------------------------------------------------------------------


def _order_key(x):
    """Integer keys of ``x`` in IEEE total order (-0.0 before +0.0), the
    order the JAX package's sorts compare floats in."""
    if x.dtype == torch.float64:
        i = x.contiguous().view(torch.int64)
        return torch.where(i < 0, i ^ 0x7FFFFFFFFFFFFFFF, i)
    i = x.float().contiguous().view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def _desc_order(x):
    """Indices sorting ``x`` (last dim) descending, equal values by
    ascending index: ``jnp.argsort(-x)`` and ``jax.lax.top_k``'s order."""
    return torch.sort(_order_key(x), dim=-1, descending=True,
                      stable=True).indices


def _top_k(x, k):
    """(values, indices) of the k largest along the last dim, as
    ``jax.lax.top_k`` gives them."""
    idx = _desc_order(x)[..., :k]
    return x.gather(-1, idx), idx


def _take(x, idx):
    """``x[..., idx, :]`` along dim -2 for ``x`` [..., N, D] and ``idx``
    [..., K] (same leading dims): a gather with unique reads."""
    return x.gather(-2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _rows(table, idx):
    """Rows of a 2-D ``table`` at ``idx`` (any shape, in range), the
    backward by ``segment_sum`` when the table needs a gradient."""
    idx = idx.long()
    if table.requires_grad:
        return _Lookup.apply(table, idx)
    return table[idx]


def _one_hot(labels, n, dtype):
    """``jax.nn.one_hot``: a label outside [0, n) gives a zero row."""
    return (labels[..., None] == torch.arange(
        n, device=labels.device)).to(dtype)


# -- box utilities ------------------------------------------------------------


def box_area(boxes, normalized: bool = True):
    """[..., 4] xyxy → area. Un-normalized (pixel) boxes count the +1 edge
    pixel, matching the reference's BBoxArea (bbox_util.h)."""
    off = 0.0 if normalized else 1.0
    w = torch.clamp(boxes[..., 2] - boxes[..., 0] + off, min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1] + off, min=0.0)
    return w * h


def pairwise_iou(a, b, normalized: bool = True):
    """a [..., N, 4], b [..., M, 4] xyxy → IoU [..., N, M] (reference:
    iou_similarity_op.h); leading dims broadcast."""
    off = 0.0 if normalized else 1.0
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + off, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = (box_area(a, normalized)[..., :, None]
             + box_area(b, normalized)[..., None, :] - inter)
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)


def _const(ctx, key, values, dtype, device):
    """A tensor of host ``values``, made once per op, key and device."""
    return _cached(ctx, ("const", key, device, dtype), lambda: torch.tensor(
        values, dtype=dtype).to(device), slot=None)


# -- iou_similarity -----------------------------------------------------------


@register_op("iou_similarity")
def iou_similarity_op(ctx: OpContext):
    """reference: detection/iou_similarity_op.cc — X [N,4], Y [M,4] → [N,M];
    batched X [B,N,4] against Y [B,M,4] or a shared [M,4]."""
    x, y = ctx.input("X"), ctx.input("Y")
    ctx.set_output("Out", pairwise_iou(x, y, ctx.attr("box_normalized", True)))


# -- box_coder ----------------------------------------------------------------


@register_op("box_coder")
def box_coder_op(ctx: OpContext):
    """reference: detection/box_coder_op.cc.

    encode_center_size: TargetBox [N,4] (or [B,N,4]) vs PriorBox [M,4] →
    [N,M,4]; decode_center_size: TargetBox [N,M,4] + PriorBox → [N,M,4]
    (axis=1 swaps which dim the priors broadcast over in decode). The
    variance is the PriorBoxVar input, else the ``variance`` attr, else 1.
    """
    prior = ctx.input("PriorBox")
    prior_var = ctx.input("PriorBoxVar")
    target = ctx.input("TargetBox")
    code_type = ctx.attr("code_type", "encode_center_size")
    normalized = ctx.attr("box_normalized", True)
    axis = ctx.attr("axis", 0)
    attr_var = ctx.attr("variance", [])

    off = 0.0 if normalized else 1.0
    pw = prior[:, 2] - prior[:, 0] + off
    ph = prior[:, 3] - prior[:, 1] + off
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5

    if prior_var is not None:
        var = prior_var
    elif attr_var:
        var = _const(ctx, ("variance",), [float(v) for v in attr_var],
                     prior.dtype, prior.device).expand(prior.shape)
    else:
        var = torch.ones_like(prior)

    if code_type.lower() in ("encode_center_size", "encodecentersize"):
        tw = target[..., 2] - target[..., 0] + off
        th = target[..., 3] - target[..., 1] + off
        tcx = target[..., 0] + tw * 0.5
        tcy = target[..., 1] + th * 0.5
        dx = (tcx[..., :, None] - pcx) / pw
        dy = (tcy[..., :, None] - pcy) / ph
        dw = torch.log(torch.abs(tw[..., :, None] / pw))
        dh = torch.log(torch.abs(th[..., :, None] / ph))
        out = torch.stack([dx, dy, dw, dh], dim=-1) / var
    else:  # decode_center_size
        if target.dim() == 2:
            target = target[:, None, :]
        if axis == 0:  # priors along dim 1
            pw_, ph_, pcx_, pcy_, var_ = (a[None] for a in (pw, ph, pcx, pcy, var))
        else:          # priors along dim 0
            pw_, ph_, pcx_, pcy_, var_ = (a[:, None] for a in (pw, ph, pcx, pcy, var))
        t = target * var_ if var_.dim() == target.dim() else target * var_[..., None]
        cx = t[..., 0] * pw_ + pcx_
        cy = t[..., 1] * ph_ + pcy_
        w = torch.exp(t[..., 2]) * pw_
        h = torch.exp(t[..., 3]) * ph_
        out = torch.stack([cx - w * 0.5, cy - h * 0.5,
                           cx + w * 0.5 - off, cy + h * 0.5 - off], dim=-1)
    ctx.set_output("OutputBox", out)


# -- prior_box / density_prior_box / anchor_generator -------------------------


def _grid(h, w, offset, step_w, step_h, dtype):
    """Cell centres (cx [H, W], cy [H, W]) on the CPU, as the JAX op's
    ``meshgrid`` of ``(arange + offset) * step``."""
    cx = (torch.arange(w, dtype=dtype) + offset) * step_w
    cy = (torch.arange(h, dtype=dtype) + offset) * step_h
    return torch.meshgrid(cx, cy, indexing="xy")


def _set_boxes(ctx, slot, key, make, variances, dtype):
    """Outputs ``slot`` (the boxes ``make()`` computes on the CPU) and
    ``Variances`` (broadcast to their shape), each made once per op and
    device."""
    dev = ctx.device
    boxes = _cached(ctx, (slot, key, dev), lambda: make().to(dev), slot=slot)
    ctx.set_output(slot, boxes)
    ctx.set_output("Variances", _cached(
        ctx, ("Variances", key, dev), lambda: torch.tensor(
            variances, dtype=dtype).expand(boxes.shape).contiguous().to(dev),
        slot="Variances"))


def _float32(values):
    return torch.tensor(np.asarray(values, np.float32))


@register_op("prior_box")
def prior_box_op(ctx: OpContext):
    """reference: detection/prior_box_op.cc. Boxes [H,W,P,4] normalized."""
    feat = ctx.input("Input")
    image = ctx.input("Image")
    min_sizes = [float(s) for s in ctx.attr("min_sizes")]
    max_sizes = [float(s) for s in ctx.attr("max_sizes", []) or []]
    ars = [1.0]
    for r in ctx.attr("aspect_ratios", []) or []:
        r = float(r)
        if not any(abs(r - e) < 1e-6 for e in ars):
            ars.append(r)
            if ctx.attr("flip", False):
                ars.append(1.0 / r)
    variances = [float(v) for v in ctx.attr("variances", [0.1, 0.1, 0.2, 0.2])]
    clip = ctx.attr("clip", False)
    offset = float(ctx.attr("offset", 0.5))
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    step_w = float(ctx.attr("step_w", 0.0)) or iw / w
    step_h = float(ctx.attr("step_h", 0.0)) or ih / h
    mmorder = ctx.attr("min_max_aspect_ratios_order", False)

    whs = []
    for k, ms in enumerate(min_sizes):
        whs.append((ms, ms))
        if not mmorder:
            for r in ars:
                if abs(r - 1.0) < 1e-6:
                    continue
                sr = np.sqrt(r)
                whs.append((ms * sr, ms / sr))
        if max_sizes:
            bs = np.sqrt(ms * max_sizes[k])
            whs.append((bs, bs))
        if mmorder:
            for r in ars:
                if abs(r - 1.0) < 1e-6:
                    continue
                sr = np.sqrt(r)
                whs.append((ms * sr, ms / sr))
    dtype = feat.dtype

    def make():
        wh = _float32(whs).to(dtype)                        # [P, 2]
        cxg, cyg = _grid(h, w, offset, step_w, step_h, dtype)
        bw = wh[:, 0] / 2.0 / iw
        bh = wh[:, 1] / 2.0 / ih
        boxes = torch.stack([
            cxg[..., None] / iw - bw, cyg[..., None] / ih - bh,
            cxg[..., None] / iw + bw, cyg[..., None] / ih + bh,
        ], dim=-1)                                           # [H, W, P, 4]
        return torch.clamp(boxes, 0.0, 1.0) if clip else boxes

    _set_boxes(ctx, "Boxes", (h, w, ih, iw, dtype), make, variances, dtype)


@register_op("density_prior_box")
def density_prior_box_op(ctx: OpContext):
    """reference: detection/density_prior_box_op.cc — dense sampling grid per
    fixed_size/density pair."""
    feat = ctx.input("Input")
    image = ctx.input("Image")
    fixed_sizes = [float(s) for s in ctx.attr("fixed_sizes", [])]
    fixed_ratios = [float(r) for r in ctx.attr("fixed_ratios", [])]
    densities = [int(d) for d in ctx.attr("densities", [])]
    variances = [float(v) for v in ctx.attr("variances", [0.1, 0.1, 0.2, 0.2])]
    clip = ctx.attr("clip", False)
    offset = float(ctx.attr("offset", 0.5))
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    step_w = float(ctx.attr("step_w", 0.0)) or iw / w
    step_h = float(ctx.attr("step_h", 0.0)) or ih / h

    locs = []  # (shift_x, shift_y, half_w, half_h)
    for size, density in zip(fixed_sizes, densities):
        shift = size / density
        for r in fixed_ratios:
            sr = np.sqrt(r)
            bw2, bh2 = size * sr / 2.0, size / sr / 2.0
            for di in range(density):
                for dj in range(density):
                    locs.append((-size / 2.0 + shift / 2.0 + dj * shift,
                                 -size / 2.0 + shift / 2.0 + di * shift,
                                 bw2, bh2))
    dtype = feat.dtype

    def make():
        loc = _float32(locs).to(dtype)                      # [P, 4]
        cxg, cyg = _grid(h, w, offset, step_w, step_h, dtype)
        ccx = cxg[..., None] + loc[:, 0]
        ccy = cyg[..., None] + loc[:, 1]
        boxes = torch.stack([
            (ccx - loc[:, 2]) / iw, (ccy - loc[:, 3]) / ih,
            (ccx + loc[:, 2]) / iw, (ccy + loc[:, 3]) / ih,
        ], dim=-1)
        return torch.clamp(boxes, 0.0, 1.0) if clip else boxes

    _set_boxes(ctx, "Boxes", (h, w, ih, iw, dtype), make, variances, dtype)


@register_op("anchor_generator")
def anchor_generator_op(ctx: OpContext):
    """reference: detection/anchor_generator_op.cc — RPN anchors in input
    (pixel) coordinates, Anchors [H,W,A,4]."""
    feat = ctx.input("Input")
    sizes = [float(s) for s in ctx.attr("anchor_sizes", [])]
    ratios = [float(r) for r in ctx.attr("aspect_ratios", [])]
    stride = [float(s) for s in ctx.attr("stride", [])]
    variances = [float(v) for v in ctx.attr("variances", [0.1, 0.1, 0.2, 0.2])]
    offset = float(ctx.attr("offset", 0.5))
    h, w = feat.shape[2], feat.shape[3]

    whs = []
    for r in ratios:
        for s in sizes:
            wa = np.sqrt(s * s / r)
            whs.append((wa, wa * r))
    dtype = feat.dtype

    def make():
        wh = _float32(whs).to(dtype)                        # [A, 2]
        cxg, cyg = _grid(h, w, offset, stride[0], stride[1], dtype)
        bw, bh = wh[:, 0] / 2.0, wh[:, 1] / 2.0
        return torch.stack([
            cxg[..., None] - bw, cyg[..., None] - bh,
            cxg[..., None] + bw, cyg[..., None] + bh,
        ], dim=-1)

    _set_boxes(ctx, "Anchors", (h, w, dtype), make, variances, dtype)


# -- box_clip -----------------------------------------------------------------


def _clip_xyxy(boxes, hm, wm):
    """Clip x to [0, wm] and y to [0, hm] (``jnp.clip``: max, then min)."""
    x1 = torch.minimum(torch.clamp(boxes[..., 0], min=0.0), wm)
    y1 = torch.minimum(torch.clamp(boxes[..., 1], min=0.0), hm)
    x2 = torch.minimum(torch.clamp(boxes[..., 2], min=0.0), wm)
    y2 = torch.minimum(torch.clamp(boxes[..., 3], min=0.0), hm)
    return torch.stack([x1, y1, x2, y2], dim=-1)


@register_op("box_clip")
def box_clip_op(ctx: OpContext):
    """reference: detection/box_clip_op.cc — clip to im_info [B,3] (h,w,scale);
    boxes [B,N,4] (batched dense replacing the reference's LoD)."""
    boxes = ctx.input("Input")
    im_info = ctx.input("ImInfo")
    h = im_info[:, 0] / im_info[:, 2] - 1.0
    w = im_info[:, 1] / im_info[:, 2] - 1.0
    if boxes.dim() == 2:
        out = _clip_xyxy(boxes, h[0], w[0])
    else:
        out = _clip_xyxy(boxes, h[:, None], w[:, None])
    ctx.set_output("Output", out)


# -- bipartite_match ----------------------------------------------------------


def _bipartite_match(dist, valid_rows):
    """Greedy max bipartite matching (reference: bipartite_match_op.cc
    BipartiteMatchFunctor, match_type='bipartite') over a batch.

    dist [B, N, M] (rows = gt entities, cols = priors) → (col_to_row [B, M]
    int32, col_dist [B, M]): each column's matched row or -1. min(N, M)
    steps, each taking the first maximum of the flattened matrix, as
    ``jnp.argmax`` does; no step reads the host."""
    b, n, m = dist.shape
    d = torch.where(valid_rows[..., None], dist, -1.0)
    c2r = torch.full((b, m), -1, dtype=torch.int32, device=dist.device)
    cdist = torch.zeros((b, m), dtype=dist.dtype, device=dist.device)
    rows = torch.arange(n, device=dist.device)[None, :, None]
    cols = torch.arange(m, device=dist.device)[None, None, :]
    for _ in range(min(n, m)):
        flat_d = d.reshape(b, -1)
        flat = flat_d.argmax(dim=1)
        best = flat_d.gather(1, flat[:, None])               # [B, 1]
        i, j = flat // m, flat % m
        take = best > 0.0
        hit = take & (cols[:, 0] == j[:, None])              # [B, M]
        c2r = torch.where(hit, i[:, None].to(torch.int32), c2r)
        cdist = torch.where(hit, best, cdist)
        kill = take[..., None] & ((rows == i[:, None, None])
                                  | (cols == j[:, None, None]))
        d = d.masked_fill(kill, -1.0)
    return c2r, cdist


@register_op("bipartite_match")
def bipartite_match_op(ctx: OpContext):
    """DistMat [B,N,M] (or [N,M]) → ColToRowMatchIndices [B,M],
    ColToRowMatchDist [B,M]. Rows whose distances are all <= 0 are padding.
    ``per_prediction`` then gives each unmatched column its best row when
    that distance reaches ``dist_threshold``."""
    dist = ctx.input("DistMat")
    match_type = ctx.attr("match_type", "bipartite")
    thresh = float(ctx.attr("dist_threshold", 0.5))
    squeeze = dist.dim() == 2
    if squeeze:
        dist = dist[None]
    valid = torch.any(dist > 0.0, dim=2)                     # [B, N]
    c2r, cd = _bipartite_match(dist, valid)
    if match_type == "per_prediction":
        masked = torch.where(valid[..., None], dist, -1.0)
        best_row = masked.argmax(dim=1).to(torch.int32)
        best_val = masked.amax(dim=1)
        un = c2r < 0
        er = torch.where(un, best_row, c2r)
        ed = torch.where(un, best_val, cd)
        ok = ed >= thresh
        c2r = torch.where((c2r < 0) & ok, er, c2r)
        cd = torch.where((cd == 0) & ok, ed, cd)
    if squeeze:
        c2r, cd = c2r[0], cd[0]
    ctx.set_output("ColToRowMatchIndices", c2r)
    ctx.set_output("ColToRowMatchDist", cd)


# -- target_assign ------------------------------------------------------------


@register_op("target_assign")
def target_assign_op(ctx: OpContext):
    """reference: detection/target_assign_op.cc (TargetAssignFunctor).

    X [B, Ng, P, K] (or [B, Ng, K] ≡ P=1), MatchIndices [B, M] →
    Out [B, M, K] with out[b, m] = X[b, match[b, m], m % P]; mismatched
    entries (index<0) get ``mismatch_value`` / weight 0. Optional NegMask
    [B, M]: masked entries get mismatch_value with weight **1** — the
    hard-negative conf target."""
    x = ctx.input("X")
    match = ctx.input("MatchIndices")
    neg_mask = ctx.input("NegMask")
    mismatch = ctx.attr("mismatch_value", 0)
    if x.dim() == 3:
        x = x[:, :, None, :]
    b, ng, p, k = x.shape
    m = match.shape[1]
    cols = torch.arange(m, device=x.device) % p
    safe = torch.clamp(match.long(), 0, ng - 1)
    flat = (torch.arange(b, device=x.device)[:, None] * ng + safe) * p + cols
    out = _rows(x.reshape(b * ng * p, k), flat)               # [B, M, K]
    ok = (match >= 0)[..., None]
    out = torch.where(ok, out, mismatch)
    w = ok.to(torch.float32)
    if neg_mask is not None:
        neg = (neg_mask > 0)[..., None]
        out = torch.where(neg, mismatch, out)
        w = torch.where(neg, 1.0, w)
    ctx.set_output("Out", out.to(x.dtype))
    ctx.set_output("OutWeight", w)


# -- NMS ----------------------------------------------------------------------


def nms_keep_mask(boxes, scores, iou_threshold, eta=1.0, normalized=True):
    """Greedy NMS over score-descending order without reordering the output:
    a bool keep mask. boxes [..., K, 4], scores [..., K] (−inf = invalid);
    the leading dims are independent problems. K steps over the batch,
    none of which reads the host. With ``eta`` < 1 the threshold decays by
    ``eta`` after each kept box while above 0.5."""
    k = boxes.shape[-2]
    order = _desc_order(scores)
    b_sorted = _take(boxes, order)
    s_sorted = scores.gather(-1, order)
    iou = pairwise_iou(b_sorted, b_sorted, normalized)      # symmetric
    valid = s_sorted > -_INF
    keep = torch.zeros_like(valid)
    if eta < 1.0:
        thresh = torch.full(scores.shape[:-1], iou_threshold,
                            dtype=torch.float32, device=scores.device)
        for i in range(k):
            sup = (keep & (iou[..., i, :] > thresh[..., None])).any(-1)
            ki = valid[..., i] & ~sup
            keep[..., i] = ki
            thresh = torch.where(ki & (thresh > 0.5), thresh * eta, thresh)
    else:
        over = iou > float(np.float32(iou_threshold))
        for i in range(k):
            keep[..., i] = valid[..., i] & ~(keep & over[..., i, :]).any(-1)
    return torch.zeros_like(keep).scatter(-1, order, keep)


@register_op("multiclass_nms")
def multiclass_nms_op(ctx: OpContext):
    """reference: detection/multiclass_nms_op.cc.

    BBoxes [B, M, 4] + Scores [B, C, M] → Out [B, keep_top_k, 6]
    (label, score, x1, y1, x2, y2; padded with -1) + Length [B]. All
    images and classes run their NMS as one batch.
    """
    bboxes = ctx.input("BBoxes")
    scores = ctx.input("Scores")
    bg = ctx.attr("background_label", 0)
    score_thresh = float(ctx.attr("score_threshold", 0.0))
    nms_top_k = int(ctx.attr("nms_top_k", -1))
    nms_thresh = float(ctx.attr("nms_threshold", 0.3))
    eta = float(ctx.attr("nms_eta", 1.0))
    keep_top_k = int(ctx.attr("keep_top_k", -1))
    normalized = ctx.attr("normalized", True)

    b, c, m = scores.shape
    k1 = min(nms_top_k, m) if nms_top_k > 0 else m
    ktot = keep_top_k if keep_top_k > 0 else c * k1
    has_bg = 0 <= bg < c
    if has_bg:
        scores = torch.cat([scores[:, :bg], scores[:, bg + 1:]], dim=1)
    cn = scores.shape[1]

    s = torch.where(scores > score_thresh, scores, -_INF)
    top_s, top_i = _top_k(s, k1)                             # [B, Cn, k1]
    top_b = _take(bboxes[:, None].expand(b, cn, m, 4), top_i)
    keep = nms_keep_mask(top_b, top_s, nms_thresh, eta, normalized)
    flat_s = torch.where(keep, top_s, -_INF).reshape(b, cn * k1)
    flat_b = top_b.reshape(b, cn * k1, 4)
    pos = torch.arange(cn * k1, device=scores.device) // k1
    labels = (pos + (pos >= bg).long() if has_bg else pos).to(scores.dtype)

    kk = min(ktot, cn * k1)
    sel_s, sel_i = _top_k(flat_s, kk)
    sel_b = _take(flat_b, sel_i)
    sel_l = labels[sel_i]
    valid = sel_s > -_INF
    out = torch.cat([sel_l[..., None], sel_s[..., None], sel_b], dim=-1)
    out = torch.where(valid[..., None], out, -1.0)
    if ktot > kk:
        out = torch.cat([out, out.new_full((b, ktot - kk, 6), -1.0)], dim=1)
    length = valid.sum(-1).to(torch.int32)
    ctx.set_output("Out", out)
    ctx.set_output("Length", length)
    ctx.set_output("Index", length)  # alias slot some callers wire


# -- RoI pooling --------------------------------------------------------------


def _channels_last_table(x):
    """[N, C, H, W] → [N·H·W, C]: the rows the RoI gathers read."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n * h * w, c)


def _batch_ids(batch_id, rois, n):
    if batch_id is None:
        return torch.zeros(rois.shape[0], dtype=torch.long, device=rois.device)
    return torch.clamp(batch_id.reshape(-1).long(), 0, n - 1)


@register_op("roi_align")
def roi_align_op(ctx: OpContext):
    """X [N,C,H,W], ROIs [R,4] + BatchId [R] → [R, C, ph, pw]
    (reference: operators/roi_align_op.cc; ``sampling_ratio`` <= 0 takes 2
    samples a bin, the JAX package's static-shape deviation from the
    adaptive ceil). Each of the s·s samples of a bin is the bilinear mix
    of four feature rows; the bins' mean is their sum over s·s."""
    x = ctx.input("X")
    rois = ctx.input("ROIs")
    ph = int(ctx.attr("pooled_height", 1))
    pw = int(ctx.attr("pooled_width", 1))
    scale = float(ctx.attr("spatial_scale", 1.0))
    sampling = int(ctx.attr("sampling_ratio", -1))
    n, c, h, w = x.shape
    bid = _batch_ids(ctx.input("BatchId"), rois, n)
    dt, dev = x.dtype, x.device
    x1, y1, x2, y2 = (rois[:, k].to(dt) * scale for k in range(4))
    rw = torch.clamp(x2 - x1, min=1e-6)
    rh = torch.clamp(y2 - y1, min=1e-6)
    bin_w = (rw / pw)[:, None, None]
    bin_h = (rh / ph)[:, None, None]
    s = sampling if sampling > 0 else 2
    i_s = torch.arange(s, dtype=dt, device=dev) + 0.5
    py = torch.arange(ph, dtype=dt, device=dev)[None, :, None]
    px = torch.arange(pw, dtype=dt, device=dev)[None, :, None]
    ys = y1[:, None, None] + py * bin_h + i_s * bin_h / s     # [R, ph, s]
    xs = x1[:, None, None] + px * bin_w + i_s * bin_w / s     # [R, pw, s]
    table = _channels_last_table(x)
    base = (bid * (h * w))[:, None, None]
    acc = None
    for a in range(s):
        yy = torch.clamp(ys[:, :, a], 0.0, h - 1.0)[:, :, None]   # [R, ph, 1]
        y0 = torch.floor(yy).long()
        y1i = torch.clamp(y0 + 1, max=h - 1)
        ly = yy - y0
        for bb in range(s):
            xx = torch.clamp(xs[:, :, bb], 0.0, w - 1.0)[:, None, :]
            x0 = torch.floor(xx).long()
            x1i = torch.clamp(x0 + 1, max=w - 1)
            lx = xx - x0
            v = (_rows(table, base + y0 * w + x0) * ((1 - ly) * (1 - lx))[..., None]
                 + _rows(table, base + y0 * w + x1i) * ((1 - ly) * lx)[..., None]
                 + _rows(table, base + y1i * w + x0) * (ly * (1 - lx))[..., None]
                 + _rows(table, base + y1i * w + x1i) * (ly * lx)[..., None])
            acc = v if acc is None else acc + v
    ctx.set_output("Out", (acc / (s * s)).permute(0, 3, 1, 2))


@register_op("roi_pool")
def roi_pool_op(ctx: OpContext):
    """Max-pool RoI (reference: operators/roi_pool_op.cc). Integer bin
    boundaries like the reference (rounded roi coords); an empty bin is 0.
    Each RoI reads its image's rows of X through ``_rows``."""
    x = ctx.input("X")
    rois = ctx.input("ROIs")
    ph = int(ctx.attr("pooled_height", 1))
    pw = int(ctx.attr("pooled_width", 1))
    scale = float(ctx.attr("spatial_scale", 1.0))
    n, c, h, w = x.shape
    bid = _batch_ids(ctx.input("BatchId"), rois, n)
    feat = _rows(x.reshape(n, c * h * w), bid).reshape(-1, c, h, w)
    ygrid = torch.arange(h, dtype=torch.float32, device=x.device)
    xgrid = torch.arange(w, dtype=torch.float32, device=x.device)
    r = rois.float()
    x1 = torch.round(r[:, 0] * scale)[:, None]
    y1 = torch.round(r[:, 1] * scale)[:, None]
    x2 = torch.round(r[:, 2] * scale)[:, None]
    y2 = torch.round(r[:, 3] * scale)[:, None]
    bw = torch.clamp(x2 - x1 + 1.0, min=1.0) / pw
    bh = torch.clamp(y2 - y1 + 1.0, min=1.0) / ph
    rows = []
    for i in range(ph):
        ys = torch.clamp(torch.floor(y1 + i * bh), 0, h)
        ye = torch.clamp(torch.ceil(y1 + (i + 1) * bh), 0, h)
        ym = (ygrid >= ys) & (ygrid < ye)                    # [R, H]
        cols = []
        for j in range(pw):
            xs = torch.clamp(torch.floor(x1 + j * bw), 0, w)
            xe = torch.clamp(torch.ceil(x1 + (j + 1) * bw), 0, w)
            xm = (xgrid >= xs) & (xgrid < xe)                # [R, W]
            mask = ym[:, :, None] & xm[:, None, :]           # [R, H, W]
            v = torch.where(mask[:, None], feat, -_INF).amax(dim=(2, 3))
            empty = ~mask.any(dim=(1, 2))
            cols.append(torch.where(empty[:, None], 0.0, v))
        rows.append(torch.stack(cols, dim=-1))
    ctx.set_output("Out", torch.stack(rows, dim=-2))       # [R, C, ph, pw]


# -- mine_hard_examples -------------------------------------------------------


@register_op("mine_hard_examples")
def mine_hard_examples_op(ctx: OpContext):
    """reference: detection/mine_hard_examples_op.cc (max_negative mining).

    ClsLoss [B, P], MatchIndices [B, P] → NegMask [B, P] (the static-shape
    replacement for the reference's LoD NegIndices: a 0/1 mask of the
    selected hard negatives, the ``neg_pos_ratio`` × positives largest
    losses among unmatched priors under ``neg_dist_threshold``) and
    UpdatedMatchIndices (the matches, unchanged).
    """
    cls_loss = ctx.input("ClsLoss").detach()
    match = ctx.input("MatchIndices")
    neg_pos_ratio = float(ctx.attr("neg_pos_ratio", 1.0))
    neg_overlap = float(ctx.attr("neg_dist_threshold", 0.5))
    match_dist = ctx.input("MatchDist")
    if match_dist is None:
        match_dist = torch.ones_like(cls_loss)
    p = match.shape[1]
    pos = match >= 0
    n_pos = pos.sum(1, keepdim=True, dtype=torch.int32)
    n_neg = torch.clamp((n_pos.to(torch.float32) * neg_pos_ratio)
                        .to(torch.int32), max=p)
    cand = ~pos & (match_dist < neg_overlap)
    neg_loss = torch.where(cand, cls_loss, -_INF)
    order = _desc_order(neg_loss)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(p, device=order.device).expand_as(order))
    neg_mask = cand & (rank < n_neg) & torch.isfinite(neg_loss)
    ctx.set_output("NegMask", neg_mask.to(torch.int32))
    ctx.set_output("UpdatedMatchIndices", match)


# -- polygon_box_transform ----------------------------------------------------


@register_op("polygon_box_transform")
def polygon_box_transform_op(ctx: OpContext):
    """reference: detection/polygon_box_transform_op.cc — offsets→absolute
    quad coords: out[c] = 4*(idx) - in[c] per axis pair."""
    x = ctx.input("Input")  # [N, geo(8), H, W]
    n, g, h, w = x.shape
    ix = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, None, :]
    iy = torch.arange(h, dtype=x.dtype, device=x.device)[None, None, :, None]
    is_x = (torch.arange(g, device=x.device) % 2 == 0)[None, :, None, None]
    base = torch.where(is_x, ix, iy) * 4.0
    ctx.set_output("Output", base - x)


# -- yolov3_loss --------------------------------------------------------------


def _bce(logit, target):
    return (torch.maximum(logit, torch.zeros_like(logit)) - logit * target
            + torch.log1p(torch.exp(-torch.abs(logit))))


def _by_slot(slot, values, like):
    """values[slot] for a small host list, as a chain of ``where``s."""
    out = torch.full_like(like, float(values[0]))
    for s in range(1, len(values)):
        out = torch.where(slot == s, float(values[s]), out)
    return out


def _cxcywh_iou(a, b):
    ax1, ay1 = a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2
    ax2, ay2 = a[..., 0] + a[..., 2] / 2, a[..., 1] + a[..., 3] / 2
    bx1, by1 = b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2
    bx2, by2 = b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), min=0.0)
    inter = iw * ih
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)


@register_op("yolov3_loss")
def yolov3_loss_op(ctx: OpContext):
    """reference: detection/yolov3_loss_op.cc (v1.3 semantics).

    X [N, A*(5+C), H, W]; GTBox [N, B, 4] (cx, cy, w, h normalized to [0,1],
    rows with w*h<=0 are padding); GTLabel [N, B] int. Loss [N]:
    BCE(x,y)+L1(w,h) weighted (2 - w*h) for matched cells, objectness BCE
    with ignore_thresh masking, class BCE. Each gt goes to the best anchor
    over *all* anchors (by wh-IoU) and counts only if that anchor is in
    this head's mask. The assigned cells' channels are rows of a
    cells-major table, read through ``_rows``.
    """
    x = ctx.input("X")
    gtbox = ctx.input("GTBox").float()
    gtlabel = ctx.input("GTLabel").long()
    anchors = [float(a) for a in ctx.attr("anchors", [])]
    mask = [int(i) for i in ctx.attr("anchor_mask", []) or list(range(len(anchors) // 2))]
    class_num = int(ctx.attr("class_num"))
    ignore = float(ctx.attr("ignore_thresh", 0.7))
    down = int(ctx.attr("downsample_ratio", 32))

    n, _, h, w = x.shape
    na = len(mask)
    all_anchors = np.asarray(anchors, np.float32).reshape(-1, 2)
    m_anchors = all_anchors[mask]
    in_h, in_w = h * down, w * down
    dev = x.device

    x5 = x.reshape(n, na, 5 + class_num, h, w).float()
    tobj = x5[:, :, 4]
    gt_valid = (gtbox[..., 2] > 0) & (gtbox[..., 3] > 0)           # [N, B]

    with torch.no_grad():
        # ignore mask: max IoU of each prediction vs any gt > thresh
        xd = x5[:, :, :4].detach()
        gx = (torch.sigmoid(xd[:, :, 0])
              + torch.arange(w, dtype=torch.float32, device=dev)) / w
        gy = (torch.sigmoid(xd[:, :, 1])
              + torch.arange(h, dtype=torch.float32, device=dev)[:, None]) / h
        gw = torch.stack([torch.exp(xd[:, s, 2]) * float(m_anchors[s, 0])
                          for s in range(na)], 1) / in_w
        gh = torch.stack([torch.exp(xd[:, s, 3]) * float(m_anchors[s, 1])
                          for s in range(na)], 1) / in_h
        pred = torch.stack([gx, gy, gw, gh], dim=-1)              # [N,na,H,W,4]
        iou_pg = _cxcywh_iou(pred[:, :, :, :, None, :],
                             gtbox[:, None, None, None, :, :])    # [N,na,H,W,B]
        iou_pg = torch.where(gt_valid[:, None, None, None, :], iou_pg, 0.0)
        ignore_mask = iou_pg.amax(dim=-1) > ignore                # [N,na,H,W]

        # gt → best anchor over ALL anchors by wh-IoU
        gtw = gtbox[..., 2] * in_w
        gth = gtbox[..., 3] * in_h
        ratios = []
        for aw, ah in all_anchors:
            inter = (torch.clamp(gtw, max=float(aw))
                     * torch.clamp(gth, max=float(ah)))
            union = gtw * gth + float(aw * ah) - inter
            ratios.append(inter / torch.clamp(union, min=1e-9))
        best_anchor = torch.stack(ratios, -1).argmax(-1)          # [N, B]
        slot = torch.full_like(best_anchor, -1)
        for s_i, a_i in enumerate(mask):
            slot = torch.where(best_anchor == a_i, s_i, slot)
        gi = torch.clamp((gtbox[..., 0] * w).to(torch.int32), 0, w - 1).long()
        gj = torch.clamp((gtbox[..., 1] * h).to(torch.int32), 0, h - 1).long()
        ok = gt_valid & (slot >= 0)
        sl = torch.where(ok, slot, 0)
        gii = torch.where(ok, gi, 0)
        gjj = torch.where(ok, gj, 0)
        cell = (sl * h + gjj) * w + gii                              # [N, B]
        obj_t = torch.zeros((n, na * h * w), device=dev).scatter_reduce(
            1, cell, ok.float(), reduce="amax").reshape(n, na, h, w)

    # per-gt losses gathered at the assigned cell
    sx = gtbox[..., 0] * w - gii
    sy = gtbox[..., 1] * h - gjj
    aw = _by_slot(sl, m_anchors[:, 0], gtbox[..., 0])
    ah = _by_slot(sl, m_anchors[:, 1], gtbox[..., 0])
    swt = torch.log(torch.clamp(gtbox[..., 2] * in_w / aw, min=1e-9))
    sht = torch.log(torch.clamp(gtbox[..., 3] * in_h / ah, min=1e-9))
    wgt = 2.0 - gtbox[..., 2] * gtbox[..., 3]

    table = x5.permute(0, 1, 3, 4, 2).reshape(n * na * h * w, 5 + class_num)
    at = _rows(table, torch.arange(n, device=dev)[:, None] * (na * h * w)
               + cell)                                               # [N, B, 5+C]
    loc = ((_bce(at[..., 0], sx) + _bce(at[..., 1], sy)) * wgt
           + (torch.abs(at[..., 2] - swt) + torch.abs(at[..., 3] - sht)) * wgt)
    cls_l = _bce(at[..., 5:], _one_hot(gtlabel, class_num, torch.float32)).sum(-1)
    per_gt = torch.where(ok, loc + cls_l, 0.0)

    obj_l = torch.where(obj_t > 0, _bce(tobj, torch.ones_like(tobj)), 0.0)
    noobj_l = torch.where((obj_t == 0) & ~ignore_mask,
                          _bce(tobj, torch.zeros_like(tobj)), 0.0)
    loss = per_gt.sum(1) + obj_l.sum((1, 2, 3)) + noobj_l.sum((1, 2, 3))
    ctx.set_output("Loss", loss)


# -- generate_proposals -------------------------------------------------------


@register_op("generate_proposals")
def generate_proposals_op(ctx: OpContext):
    """RPN proposal generation (reference: detection/generate_proposals_op.cc).

    Scores [B, A, H, W], BboxDeltas [B, 4A, H, W], ImInfo [B, 3],
    Anchors [H, W, A, 4], Variances like Anchors →
    RpnRois [B, post_nms_topN, 4] (padded -1), RpnRoiProbs [B, post, 1]
    + Length [B]. The NMS is ``pre_nms_topN`` steps over the batch.
    """
    scores = ctx.input("Scores")
    deltas = ctx.input("BboxDeltas")
    im_info = ctx.input("ImInfo")
    anchors = ctx.input("Anchors").reshape(-1, 4)
    variances = ctx.input("Variances").reshape(-1, 4)
    pre_n = int(ctx.attr("pre_nms_topN", 6000))
    post_n = int(ctx.attr("post_nms_topN", 1000))
    nms_thresh = float(ctx.attr("nms_thresh", 0.7))
    min_size = float(ctx.attr("min_size", 0.1))

    b, a, h, w = scores.shape
    pre_n = min(pre_n, a * h * w)
    sc = scores.permute(0, 2, 3, 1).reshape(b, -1)
    dl = deltas.reshape(b, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(b, -1, 4)

    top_s, top_i = _top_k(sc, pre_n)                          # [B, pre]
    anc = anchors[top_i]                                      # [B, pre, 4]
    var = variances[top_i]
    aw = anc[..., 2] - anc[..., 0] + 1.0
    ah = anc[..., 3] - anc[..., 1] + 1.0
    acx = anc[..., 0] + aw * 0.5
    acy = anc[..., 1] + ah * 0.5
    t = _take(dl, top_i) * var
    cx = t[..., 0] * aw + acx
    cy = t[..., 1] * ah + acy
    bw = torch.exp(torch.clamp(t[..., 2], max=10.0)) * aw
    bh = torch.exp(torch.clamp(t[..., 3], max=10.0)) * ah
    boxes = torch.stack([cx - bw * 0.5, cy - bh * 0.5,
                         cx + bw * 0.5 - 1.0, cy + bh * 0.5 - 1.0], dim=-1)
    boxes = _clip_xyxy(boxes, (im_info[:, 0] - 1.0)[:, None],
                       (im_info[:, 1] - 1.0)[:, None])
    ms = (min_size * im_info[:, 2])[:, None]
    keep_sz = ((boxes[..., 2] - boxes[..., 0] + 1.0 >= ms)
               & (boxes[..., 3] - boxes[..., 1] + 1.0 >= ms))
    s_f = torch.where(keep_sz, top_s, -_INF)
    keep = nms_keep_mask(boxes, s_f, nms_thresh, normalized=False)
    s_k = torch.where(keep, s_f, -_INF)
    kk = min(post_n, pre_n)
    fin_s, fin_i = _top_k(s_k, kk)
    rois = _take(boxes, fin_i)
    valid = fin_s > -_INF
    rois = torch.where(valid[..., None], rois, -1.0)
    probs = torch.where(valid, fin_s, -1.0)[..., None]
    if post_n > kk:
        rois = torch.cat([rois, rois.new_full((b, post_n - kk, 4), -1.0)], 1)
        probs = torch.cat([probs, probs.new_full((b, post_n - kk, 1), -1.0)], 1)
    ctx.set_output("RpnRois", rois)
    ctx.set_output("RpnRoiProbs", probs)
    ctx.set_output("Length", valid.sum(-1).to(torch.int32))


# -- two-stage detector training samplers -------------------------------------


def _first_k(eligible, k):
    """The first k eligible positions in index order (``use_random=False``);
    ``k`` an int or a [B, 1] tensor."""
    rank = torch.cumsum(eligible.to(torch.int32), dim=-1) - 1
    return eligible & (rank < k)


def _subsample(eligible, k, generator):
    """≤ k eligible positions uniformly at random: the JAX package's
    ``_subsample_mask`` (eligible rows ranked by uniform scores, the first
    min(k, #eligible) kept), drawn from the op's generator."""
    u = torch.rand(eligible.shape, generator=generator, device=eligible.device)
    scores = torch.where(eligible, u, -1.0)
    n_elig = eligible.sum(-1, keepdim=True, dtype=torch.int32)
    take = (torch.clamp(n_elig, max=k) if isinstance(k, int)
            else torch.minimum(n_elig, k))
    order = _desc_order(scores)
    n = eligible.shape[-1]
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=order.device).expand_as(order))
    return eligible & (rank < take)


def _fg_bg(fg_elig, bg_elig, fg_target, batch_size, use_random, ctx):
    """Sample fg (at most ``fg_target``) then bg (the rest of
    ``batch_size``) among the eligible positions."""
    gen = ctx.rng() if use_random else None
    if use_random:
        fg = _subsample(fg_elig, fg_target, gen)
    else:
        fg = _first_k(fg_elig, fg_target)
    n_bg = batch_size - fg.sum(-1, keepdim=True, dtype=torch.int32)
    bg = _subsample(bg_elig, n_bg, gen) if use_random else _first_k(bg_elig, n_bg)
    return fg, bg


def _xyxy_centers(boxes, floor=None):
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    if floor is not None:
        w, h = torch.clamp(w, min=floor), torch.clamp(h, min=floor)
    return w, h, boxes[..., 0] + w * 0.5, boxes[..., 1] + h * 0.5


@register_op("rpn_target_assign")
def rpn_target_assign_op(ctx: OpContext):
    """RPN anchor sampling (reference: detection/rpn_target_assign_op.cc).

    Anchor [A, 4]; GtBoxes [B, Ng, 4] dense (zero-area rows pad); ImInfo
    [B, 3]. The static redesign emits per-anchor masks and targets:
    ScoreMask [B, A] ∈ {-1: ignore, 0: bg sample, 1: fg sample},
    TargetLabel [B, A], TargetBBox [B, A, 4] (encoded deltas),
    BBoxInsideWeight [B, A, 4]. Sampling honors rpn_fg_fraction /
    rpn_batch_size_per_im; ``use_random`` draws from the op's generator.
    """
    anchors = ctx.input("Anchor").reshape(-1, 4)
    gt = ctx.input("GtBoxes")
    im_info = ctx.input("ImInfo")
    bs_per_im = int(ctx.attr("rpn_batch_size_per_im", 256))
    straddle = float(ctx.attr("rpn_straddle_thresh", 0.0))
    fg_frac = float(ctx.attr("rpn_fg_fraction", 0.5))
    pos_ov = float(ctx.attr("rpn_positive_overlap", 0.7))
    neg_ov = float(ctx.attr("rpn_negative_overlap", 0.3))
    use_random = ctx.attr("use_random", True)
    fg_target = int(bs_per_im * fg_frac)

    valid_gt = (gt[..., 2] > gt[..., 0]) & (gt[..., 3] > gt[..., 1])   # [B, Ng]
    if straddle >= 0:
        hh, ww = im_info[:, 0:1], im_info[:, 1:2]
        inside = ((anchors[:, 0] >= -straddle) & (anchors[:, 1] >= -straddle)
                  & (anchors[:, 2] < ww + straddle)
                  & (anchors[:, 3] < hh + straddle))                     # [B, A]
    else:
        inside = torch.ones((gt.shape[0], anchors.shape[0]), dtype=torch.bool,
                            device=gt.device)
    iou = pairwise_iou(anchors, gt, normalized=False)                    # [B, A, Ng]
    iou = torch.where(valid_gt[:, None, :], iou, 0.0)
    best_gt = iou.argmax(-1)
    best_iou = iou.amax(-1)
    per_gt_best = torch.where(inside[..., None], iou, -1.0).amax(1)      # [B, Ng]
    is_gt_best = ((iou == per_gt_best[:, None, :]) & valid_gt[:, None, :]
                  & (per_gt_best[:, None, :] > 0)).any(-1)
    fg_elig = inside & (is_gt_best | (best_iou >= pos_ov))
    bg_elig = inside & (best_iou < neg_ov) & ~fg_elig
    fg, bg = _fg_bg(fg_elig, bg_elig, fg_target, bs_per_im, use_random, ctx)
    score_mask = torch.where(fg, 1, torch.where(bg, 0, -1)).to(torch.int32)
    # encoded regression targets vs matched gt (variance-free, like the
    # reference's BoxToDelta with weights=1)
    g = _take(gt, best_gt)
    aw, ah, acx, acy = _xyxy_centers(anchors)
    gw, gh, gcx, gcy = _xyxy_centers(g)
    tgt = torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                       torch.log(torch.clamp(gw / aw, min=1e-6)),
                       torch.log(torch.clamp(gh / ah, min=1e-6))], dim=-1)
    tgt = torch.where(fg[..., None], tgt, 0.0)
    inw = fg[..., None].to(tgt.dtype).expand(*fg.shape, 4)
    ctx.set_output("ScoreMask", score_mask)
    ctx.set_output("TargetLabel", fg.to(torch.int32))
    ctx.set_output("TargetBBox", tgt)
    ctx.set_output("BBoxInsideWeight", inw.contiguous())


@register_op("generate_proposal_labels")
def generate_proposal_labels_op(ctx: OpContext):
    """Second-stage RoI sampling (reference:
    detection/generate_proposal_labels_op.cc). RpnRois [B, R, 4] (padded
    -1), GtClasses [B, Ng], GtBoxes [B, Ng, 4] →
    Rois [B, batch_size_per_im, 4], LabelsInt32 [B, S] (−1 pads),
    BboxTargets [B, S, 4·C], BboxInsideWeights / BboxOutsideWeights same
    shape, RoiWeights [B, S] (1 for sampled rows). The candidates are the
    proposals and the gt boxes; the chosen rows are packed to the front in
    index order.
    """
    rois = ctx.input("RpnRois")
    gt_classes = ctx.input("GtClasses").long()
    gt_boxes = ctx.input("GtBoxes")
    bs = int(ctx.attr("batch_size_per_im", 256))
    fg_frac = float(ctx.attr("fg_fraction", 0.25))
    fg_thresh = float(ctx.attr("fg_thresh", 0.5))
    bg_hi = float(ctx.attr("bg_thresh_hi", 0.5))
    bg_lo = float(ctx.attr("bg_thresh_lo", 0.0))
    weights = [float(v) for v in ctx.attr("bbox_reg_weights", [0.1, 0.1, 0.2, 0.2])]
    class_nums = int(ctx.attr("class_nums"))
    use_random = ctx.attr("use_random", True)
    fg_target = int(bs * fg_frac)

    b = rois.shape[0]
    valid_gt = (gt_boxes[..., 2] > gt_boxes[..., 0]) & (gt_boxes[..., 3] > gt_boxes[..., 1])
    cand = torch.cat([rois, gt_boxes], dim=1)                            # [B, R+Ng, 4]
    cand_valid = torch.cat([rois[..., 2] > rois[..., 0], valid_gt], dim=1)
    iou = pairwise_iou(cand, gt_boxes, normalized=False)
    iou = torch.where(valid_gt[:, None, :], iou, 0.0)
    best = iou.argmax(-1)
    best_iou = iou.amax(-1)
    fg_elig = cand_valid & (best_iou >= fg_thresh)
    bg_elig = cand_valid & (best_iou < bg_hi) & (best_iou >= bg_lo)
    fg, bg = _fg_bg(fg_elig, bg_elig, fg_target, bs, use_random, ctx)
    chosen = fg | bg
    order = torch.sort((~chosen).to(torch.int32), dim=-1, stable=True).indices
    take = order[:, :bs]
    sel = chosen.gather(1, take)
    r = _take(cand, take)
    out_rois = torch.where(sel[..., None], r, -1.0)
    best_t = best.gather(1, take)
    labels = torch.where(fg.gather(1, take), gt_classes.gather(1, best_t), 0)
    labels = torch.where(sel, labels, -1).to(torch.int32)
    g = _take(gt_boxes, best_t)
    rw, rh, rcx, rcy = _xyxy_centers(r)
    gw, gh, gcx, gcy = _xyxy_centers(g, floor=1e-6)
    t = torch.stack([(gcx - rcx) / rw / weights[0], (gcy - rcy) / rh / weights[1],
                     torch.log(gw / rw) / weights[2],
                     torch.log(gh / rh) / weights[3]], dim=-1)           # [B, S, 4]
    is_fg = fg.gather(1, take) & sel
    onehot = _one_hot(torch.clamp(labels, min=0), class_nums, t.dtype)   # [B, S, C]
    t_full = (onehot[..., None] * t[..., None, :]).reshape(b, bs, 4 * class_nums)
    t_full = torch.where(is_fg[..., None], t_full, 0.0)
    iw = (onehot * is_fg[..., None])[..., None].expand(
        b, bs, class_nums, 4).reshape(b, bs, 4 * class_nums)
    ctx.set_output("Rois", out_rois)
    ctx.set_output("LabelsInt32", labels)
    ctx.set_output("BboxTargets", t_full)
    ctx.set_output("BboxInsideWeights", iw)
    ctx.set_output("BboxOutsideWeights", iw)
    ctx.set_output("RoiWeights", sel.to(torch.float32))


# -- mask targets + perspective RoIs ------------------------------------------


def _point_in_polygon(px, py, verts, n_verts):
    """Even-odd rule: px/py [..., P], verts [..., L, 2], n_verts [...] →
    bool [..., P]. Vertices beyond n_verts are ignored."""
    l = verts.shape[-2]
    idx = torch.arange(l, device=verts.device)
    n = n_verts[..., None]
    nxt = torch.where(idx + 1 < n, idx + 1, 0)                        # [..., L]
    x1, y1 = verts[..., 0], verts[..., 1]
    x2 = x1.gather(-1, nxt)
    y2 = y1.gather(-1, nxt)
    valid = idx < n
    pxe, pye = px[..., None], py[..., None]
    x1, y1, x2, y2, valid = (a[..., None, :] for a in (x1, y1, x2, y2, valid))
    cond = (y1 > pye) != (y2 > pye)
    dy = torch.where(y2 == y1, 1e-9, y2 - y1)
    slope_x = x1 + (pye - y1) * (x2 - x1) / dy
    crossing = cond & (pxe < slope_x) & valid
    return crossing.sum(-1) % 2 == 1


@register_op("generate_mask_labels")
def generate_mask_labels_op(ctx: OpContext):
    """Mask R-CNN mask targets (reference:
    detection/generate_mask_labels_op.cc + mask_util.cc poly rasterization).

    GtSegms [B, Ng, L, 2] padded polygon vertices (one polygon per gt) +
    GtPolyLength [B, Ng] vertex counts replace the 3-level LoD; Rois
    [B, S, 4] with LabelsInt32 [B, S] from generate_proposal_labels.
    Outputs MaskInt32 [B, S, num_classes·R·R] (−1 everywhere except the
    matched class's R×R block for fg rois) and RoiHasMaskInt32 [B, S].
    """
    rois = ctx.input("Rois")
    labels = ctx.input("LabelsInt32").long()
    segms = ctx.input("GtSegms").float()
    poly_len = ctx.input("GtPolyLength")
    gt_classes = ctx.input("GtClasses").long()
    num_classes = int(ctx.attr("num_classes"))
    r = int(ctx.attr("resolution", 14))
    b, s, _ = rois.shape
    ng, l = segms.shape[1], segms.shape[2]
    dev = rois.device
    if poly_len is None:
        poly_len = torch.full((b, ng), l, dtype=torch.long, device=dev)
    plen = poly_len.long()

    vmask = (torch.arange(l, device=dev) < plen[..., None])[..., None]   # [B,Ng,L,1]
    big = torch.where(vmask, segms, _INF).amin(2)
    small = torch.where(vmask, segms, -_INF).amax(2)
    gt_boxes = torch.cat([big, small], dim=-1)                          # [B, Ng, 4]
    iou = pairwise_iou(rois.float(), gt_boxes, normalized=False)
    iou = torch.where((plen >= 3)[:, None, :], iou, -1.0)
    best = iou.argmax(-1)                                               # [B, S]
    is_fg = labels > 0

    grid = (torch.arange(r, dtype=torch.float32, device=dev) + 0.5) / r
    gy, gx = torch.meshgrid(grid, grid, indexing="ij")
    gx, gy = gx.reshape(-1), gy.reshape(-1)                             # [R·R]
    rf = rois.float()
    px = rf[..., 0:1] + gx * torch.clamp(rf[..., 2:3] - rf[..., 0:1], min=1e-6)
    py = rf[..., 1:2] + gy * torch.clamp(rf[..., 3:4] - rf[..., 1:2], min=1e-6)
    verts = segms.reshape(b, ng, l * 2)
    verts = _take(verts, best).reshape(b, s, l, 2)
    masks = _point_in_polygon(px, py, verts, plen.gather(1, best)).to(torch.int32)
    cls_of = gt_classes.gather(1, best)
    onehot = _one_hot(cls_of, num_classes, torch.int32)                  # [B, S, C]
    full = onehot[..., None] * masks[..., None, :]                       # [B, S, C, R·R]
    tgt_blk = (onehot[..., None] == 1) & is_fg[..., None, None]
    packed = torch.where(tgt_blk, full, -1)
    ctx.set_output("MaskInt32", packed.reshape(b, s, num_classes * r * r))
    ctx.set_output("RoiHasMaskInt32", is_fg.to(torch.int32))


@register_op("roi_perspective_transform")
def roi_perspective_transform_op(ctx: OpContext):
    """Perspective-warp quadrilateral RoIs to a fixed rectangle (reference:
    detection/roi_perspective_transform_op.cc — OCR text RoIs). ROIs
    [R, 8] quad corners (x1..y4, clockwise from top-left) + BatchId [R];
    bilinear sampling of the warped grid (zeros outside X) → [R, C, H, W]."""
    x = ctx.input("X")
    rois = ctx.input("ROIs").float()
    oh = int(ctx.attr("transformed_height"))
    ow = int(ctx.attr("transformed_width"))
    scale = float(ctx.attr("spatial_scale", 1.0))
    n, c, h, w = x.shape
    bid = _batch_ids(ctx.input("BatchId"), rois, n)
    dev = x.device
    gy, gx = torch.meshgrid((torch.arange(oh, device=dev) + 0.5) / oh,
                            (torch.arange(ow, device=dev) + 0.5) / ow,
                            indexing="ij")

    q = (rois.reshape(-1, 4, 2) * scale)[..., None, None]   # [R, 4, 2, 1, 1]
    x0, y0 = q[:, 0, 0], q[:, 0, 1]
    x1, y1 = q[:, 1, 0], q[:, 1, 1]
    x2, y2 = q[:, 2, 0], q[:, 2, 1]
    x3, y3 = q[:, 3, 0], q[:, 3, 1]
    # the projective transform unit square → quad (the reference's
    # get_transform_matrix, closed form): (u,v) ↦
    # ((a·u + b·v + c) / w, (d·u + e·v + f) / w), w = g·u + h·v + 1
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    dx1, dx2 = x1 - x2, x3 - x2
    dy1, dy2 = y1 - y2, y3 - y2
    den = dx1 * dy2 - dy1 * dx2
    den = torch.where(torch.abs(den) < 1e-12, 1e-12, den)
    g = (sx * dy2 - sy * dx2) / den
    h_ = (dx1 * sy - dy1 * sx) / den
    a = x1 - x0 + g * x1
    b_ = x3 - x0 + h_ * x3
    d_ = y1 - y0 + g * y1
    e = y3 - y0 + h_ * y3
    wgt = g * gx + h_ * gy + 1.0
    wgt = torch.where(torch.abs(wgt) < 1e-12, 1e-12, wgt)
    px = (a * gx + b_ * gy + x0) / wgt                      # [R, oh, ow]
    py = (d_ * gx + e * gy + y0) / wgt
    ix0 = torch.floor(px)
    iy0 = torch.floor(py)
    lx = px - ix0
    ly = py - iy0
    table = _channels_last_table(x)
    base = (bid * (h * w))[:, None, None]

    def gather(yy, xx):
        inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        yc = torch.clamp(yy, 0, h - 1).long()
        xc = torch.clamp(xx, 0, w - 1).long()
        v = _rows(table, base + yc * w + xc)                # [R, oh, ow, C]
        return torch.where(inb[..., None], v, 0.0)

    out = (gather(iy0, ix0) * ((1 - ly) * (1 - lx))[..., None]
           + gather(iy0, ix0 + 1) * ((1 - ly) * lx)[..., None]
           + gather(iy0 + 1, ix0) * (ly * (1 - lx))[..., None]
           + gather(iy0 + 1, ix0 + 1) * (ly * lx)[..., None])
    ctx.set_output("Out", out.permute(0, 3, 1, 2))


# -- detection_map (host op) --------------------------------------------------


@register_op("detection_map")
def detection_map_op(ctx: OpContext):
    """mAP over padded detections (reference: operators/detection_map_op.cc).

    DetectRes [B, K, 6] (label, score, x1, y1, x2, y2; -1 pad rows),
    Label [B, Ng, 5] (label, x1, y1, x2, y2; zero-area pad rows), optional
    DetLength [B]. A host op (``executor.HOST_OPS``): matching and AP run
    on the host over :class:`~paddle_tpu_torch.metrics.DetectionMAP`, per
    batch; cross-batch accumulation lives in that class.
    """
    from ..metrics import DetectionMAP

    det = ctx.input("DetectRes")
    gt = ctx.input("Label")
    det_len = ctx.input("DetLength")
    overlap = ctx.attr("overlap_threshold", 0.5)
    ap_version = ctx.attr("ap_type", "integral")
    background = int(ctx.attr("background_label", 0))
    if not ctx.attr("evaluate_difficult", True):
        raise NotImplementedError(
            "detection_map: evaluate_difficult=False needs per-gt difficult "
            "flags, which the padded [label,x1,y1,x2,y2] convention does not "
            "carry — filter difficult gts out of the feed instead")
    if det.device.type == "meta":  # shape inference
        ctx.set_output("MAP", torch.empty((), dtype=torch.float32, device=det.device))
        return
    det_h = det.detach().float().cpu().numpy().copy()
    gt_h = gt.detach().float().cpu().numpy().copy()
    len_h = (np.full((det_h.shape[0],), det_h.shape[1], np.int64)
             if det_len is None else det_len.detach().cpu().numpy())
    if background >= 0:
        # background rows don't score: void matched det rows and
        # zero-area the background gts (the metric skips both)
        det_h[det_h[..., 0] == background] = -1.0
        gt_h[gt_h[..., 0] == background] = 0.0
    m = DetectionMAP(overlap_threshold=overlap, ap_version=ap_version)
    m.update(det_h, len_h, gt_h)
    ctx.set_output("MAP", torch.tensor(np.float32(m.eval())).to(det.device))


__all__ = ["box_area", "pairwise_iou", "nms_keep_mask"]
