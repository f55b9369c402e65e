# ported from paddle_tpu/ops/vision_ops.py
"""Vision-tail ops: ``spp``, ``max_pool2d_with_index``, ``unpool``,
``grid_sampler`` and ``psroi_pool`` (reference: operators/spp_op.cc,
pool_with_index_op.cc, unpool_op.cc, grid_sampler_op.cc,
psroi_pool_op.cc).

Static shapes throughout. Adaptive bins span [floor(i·H/k),
ceil((i+1)·H/k)), the reference's rule. ``max_pool2d_with_index`` takes
its windows with ``F.unfold`` and records each maximum's position as
``h * W + w`` within its channel, the layout ``unpool`` scatters back to.
``grid_sampler`` maps the grid's [-1, 1] onto the corner pixels' centres
((g + 1)(W - 1)/2) and reads zeros outside the image, as the JAX op does
(``F.grid_sample(align_corners=True)`` is the same map, but the port
follows the JAX op's arithmetic, not a library's).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import OpContext, register_op


def _adaptive_bins(total: int, k: int):
    return ([int(math.floor(i * total / k)) for i in range(k)],
            [int(math.ceil((i + 1) * total / k)) for i in range(k)])


def _adaptive_pool2d(x, k: int, ptype: str):
    """[N, C, H, W] → [N, C, k, k] over the reference's adaptive bins."""
    hs, he = _adaptive_bins(x.shape[2], k)
    ws, we = _adaptive_bins(x.shape[3], k)
    rows = []
    for i in range(k):
        cols = []
        for j in range(k):
            win = x[:, :, hs[i]:he[i], ws[j]:we[j]]
            cols.append(torch.amax(win, dim=(2, 3)) if ptype == "max"
                        else win.mean(dim=(2, 3)))
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


@register_op("spp")
def spp_op(ctx: OpContext):
    """Spatial pyramid pooling (reference: spp_op.cc): levels of 1, 2, 4,
    ... bins a side, each flattened, concatenated → [N, C·Σ 4^l]."""
    x = ctx.input("X")
    ptype = ctx.attr("pooling_type", "max")
    outs = [_adaptive_pool2d(x, 2 ** lvl, ptype).reshape(x.shape[0], -1)
            for lvl in range(int(ctx.attr("pyramid_height", 1)))]
    ctx.set_output("Out", torch.cat(outs, dim=1))


@register_op("max_pool2d_with_index")
def max_pool2d_with_index_op(ctx: OpContext):
    """reference: pool_with_index_op.cc. Out [N, C, oh, ow] and Mask, the
    int32 position ``h * W + w`` of each window's maximum (the first on
    ties) in its channel; a padded position never wins."""
    x = ctx.input("X")
    kh, kw = ctx.attr("ksize", [2, 2])
    sh, sw = ctx.attr("strides", [kh, kw])
    ph, pw = ctx.attr("paddings", [0, 0])
    n, c, h, w = x.shape
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    cols = F.unfold(x, (kh, kw), padding=(ph, pw), stride=(sh, sw))
    cols = cols.reshape(n, c, kh * kw, oh, ow)
    # the window offsets inside the image (padding reads -inf)
    ky = torch.arange(kh, device=x.device).repeat_interleave(kw)
    kx = torch.arange(kw, device=x.device).repeat(kh)
    gy = (torch.arange(oh, device=x.device) * sh - ph)[None, :, None] \
        + ky[:, None, None]                              # [kh*kw, oh, 1]
    gx = (torch.arange(ow, device=x.device) * sw - pw)[None, None, :] \
        + kx[:, None, None]                              # [kh*kw, 1, ow]
    inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
    cols = torch.where(inside, cols, float("-inf"))
    out = torch.amax(cols, dim=2)
    arg = torch.argmax(cols, dim=2)                      # [N, C, oh, ow]
    ay, ax = arg // kw, arg % kw
    my = torch.arange(oh, device=x.device)[:, None] * sh - ph + ay
    mx = torch.arange(ow, device=x.device)[None, :] * sw - pw + ax
    ctx.set_output("Out", out)
    ctx.set_output("Mask", (my * w + mx).to(torch.int32))


@register_op("unpool")
def unpool_op(ctx: OpContext):
    """Max unpooling (reference: unpool_op.cc): X [N, C, oh, ow] scattered
    to the positions ``Indices`` holds (``h * W + w`` a channel) of a
    zero [N, C, uh, uw], its size from ``unpooled_size`` or the window."""
    x = ctx.input("X")
    indices = ctx.input("Indices").long()
    ksize = list(ctx.attr("ksize", [2, 2]))
    strides = list(ctx.attr("strides", ksize))
    unpooled = ctx.attr("unpooled_size", None)
    n, c, oh, ow = x.shape
    if unpooled:
        uh, uw = int(unpooled[0]), int(unpooled[1])
    else:
        uh = (oh - 1) * strides[0] + ksize[0]
        uw = (ow - 1) * strides[1] + ksize[1]
    out = x.new_zeros((n, c, uh * uw)).scatter(
        2, indices.reshape(n, c, -1), x.reshape(n, c, -1))
    ctx.set_output("Out", out.reshape(n, c, uh, uw))


@register_op("grid_sampler")
def grid_sampler_op(ctx: OpContext):
    """Bilinear sampling at a [-1, 1] grid (reference: grid_sampler_op.cc).
    X [N, C, H, W], Grid [N, Ho, Wo, 2] (x, y) → Output [N, C, Ho, Wo];
    -1 and 1 are the centres of the first and last pixels, and a corner
    outside the image reads 0."""
    x, grid = ctx.input("X"), ctx.input("Grid")
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0            # [N, Ho, Wo]
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0, y0 = torch.floor(gx), torch.floor(gy)
    lx, ly = (gx - x0)[:, None], (gy - y0)[:, None]
    flat = x.reshape(n, c, h * w)

    def corner(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        at = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
        v = flat.gather(2, at.reshape(n, 1, -1).expand(n, c, -1))
        return torch.where(inside[:, None], v.reshape(n, c, *yy.shape[1:]),
                           0.0)

    out = (corner(y0, x0) * (1 - ly) * (1 - lx)
           + corner(y0, x0 + 1) * (1 - ly) * lx
           + corner(y0 + 1, x0) * ly * (1 - lx)
           + corner(y0 + 1, x0 + 1) * ly * lx)
    ctx.set_output("Output", out)


@register_op("psroi_pool")
def psroi_pool_op(ctx: OpContext):
    """Position-sensitive RoI pooling (reference: psroi_pool_op.cc): X
    [N, oc·ph·pw, H, W], ROIs [R, 4] (x1, y1, x2, y2) + BatchId [R] →
    Out [R, oc, ph, pw]; bin (i, j) averages channel group (i, j) over the
    pixels it covers, all RoIs at once."""
    x, rois = ctx.input("X"), ctx.input("ROIs").float()
    batch_id = ctx.input("BatchId")
    r = rois.shape[0]
    batch_id = torch.zeros(r, dtype=torch.long, device=x.device) \
        if batch_id is None else batch_id.reshape(-1).long()
    oc = int(ctx.attr("output_channels"))
    ph, pw = int(ctx.attr("pooled_height", 1)), int(ctx.attr("pooled_width",
                                                              1))
    scale = float(ctx.attr("spatial_scale", 1.0))
    _, _, h, w = x.shape
    feat = x[batch_id].reshape(r, oc, ph, pw, h, w)
    x1 = torch.round(rois[:, 0]) * scale
    y1 = torch.round(rois[:, 1]) * scale
    x2 = torch.round(rois[:, 2] + 1.0) * scale
    y2 = torch.round(rois[:, 3] + 1.0) * scale
    bw = torch.clamp(x2 - x1, min=0.1) / pw
    bh = torch.clamp(y2 - y1, min=0.1) / ph
    ys = torch.arange(h, dtype=torch.float32, device=x.device)
    xs = torch.arange(w, dtype=torch.float32, device=x.device)
    rows = []
    for i in range(ph):
        y_lo = torch.floor(y1 + i * bh)[:, None]
        y_hi = torch.ceil(y1 + (i + 1) * bh)[:, None]
        in_y = (ys[None] >= y_lo) & (ys[None] < y_hi)    # [R, H]
        cols = []
        for j in range(pw):
            x_lo = torch.floor(x1 + j * bw)[:, None]
            x_hi = torch.ceil(x1 + (j + 1) * bw)[:, None]
            in_x = (xs[None] >= x_lo) & (xs[None] < x_hi)
            m = in_y[:, :, None] & in_x[:, None, :]      # [R, H, W]
            cnt = m.sum(dim=(1, 2)).to(x.dtype).clamp(min=1.0)
            total = torch.where(m[:, None], feat[:, :, i, j], 0.0).sum(
                dim=(2, 3))
            cols.append(total / cnt[:, None])
        rows.append(torch.stack(cols, dim=-1))
    ctx.set_output("Out", torch.stack(rows, dim=-2))
