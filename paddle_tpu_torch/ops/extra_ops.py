# ported from paddle_tpu/ops/extra_ops.py
"""The reference's remaining general ops (each docstring names its
operator): position encoding, the affine grid, two losses, sampling,
random crop, spectral norm, circular shift, similarity focus, the fused
embedding pool, 3-D max pool with indices, ``fill``, tree convolution and
``hash``. (The JAX module's ``sequence_conv``, ``sequence_reshape`` and
``lod_reset`` are in ``sequence_ops.py``, ``average_accumulates`` in
``optimizer_ops.py``.)

``sampling_id`` and ``random_crop`` draw from the op's generator, so a
captured step replays them as it replays dropout. ``tree_conv`` builds
its patch matrices on the host from a host copy of ``EdgeSet``, as the
JAX package does in a ``pure_callback``, so it is a host op of the
captured step (``executor.HOST_OPS``); its products run on the device.
``hash`` gives the JAX op's uint32 values exactly: torch has no uint32
arithmetic, so it computes in int64, multiplies by 16-bit halves of each
constant and keeps the low 32 bits after every step. ``affine_grid``
with an ``OutputShape`` tensor reads that shape on the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtypes import to_torch_dtype
from ..core.registry import OpContext, register_op
from .nn_ops import _Lookup
from .tensor_ops import _cached

_MASK32 = 0xFFFFFFFF


@register_op("add_position_encoding")
def add_position_encoding_op(ctx: OpContext):
    """reference: add_position_encoding_op.cc — X [B, T, D] → alpha·X +
    beta·PE, PE the sinusoid (sines in the first half of D, cosines in the
    second, a zero column when D is odd)."""
    x = ctx.input("X")
    alpha, beta = float(ctx.attr("alpha", 1.0)), float(ctx.attr("beta", 1.0))
    _, t, d = x.shape
    half = d // 2
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    div = torch.pow(10000.0, torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half)
    pe = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], dim=1)
    pe = F.pad(pe, (0, d - pe.shape[1]))
    ctx.set_output("Out", alpha * x + beta * pe[None].to(x.dtype))


@register_op("affine_grid")
def affine_grid_op(ctx: OpContext):
    """reference: affine_grid_op.cc — Theta [N, 2, 3] → Output
    [N, H, W, 2], the [-1, 1] grid of (x, y) mapped by each theta (the
    input of ``grid_sampler`` in a spatial transformer)."""
    theta = ctx.input("Theta")
    if ctx.has_input("OutputShape"):
        _, _, h, w = (int(s) for s in ctx.input("OutputShape").tolist())
    else:
        _, _, h, w = (int(s) for s in ctx.attr("output_shape"))
    dev = theta.device
    gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, h, device=dev),
                            torch.linspace(-1.0, 1.0, w, device=dev),
                            indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)
    out = torch.einsum("nij,pj->npi", theta.float(), base)
    ctx.set_output("Output", out.reshape(theta.shape[0], h, w, 2)
                   .to(theta.dtype))


@register_op("modified_huber_loss")
def modified_huber_loss_op(ctx: OpContext):
    """reference: modified_huber_loss_op.cc — labels {0, 1} as ±1, z =
    x·y: -4z below -1, (1 - z)² below 1, else 0."""
    x = ctx.input("X")
    z = x.float() * (2.0 * ctx.input("Y").float() - 1.0)
    loss = torch.where(z < -1.0, -4.0 * z,
                       torch.where(z < 1.0, torch.square(1.0 - z), 0.0))
    ctx.set_output("IntermediateVal", z.to(x.dtype))
    ctx.set_output("Out", loss.to(x.dtype))


@register_op("teacher_student_sigmoid_loss")
def teacher_student_sigmoid_loss_op(ctx: OpContext):
    """reference: teacher_student_sigmoid_loss_op.cc — the CTR
    distillation loss. The label packs click and teacher score
    (teacher_student_sigmoid_loss_op.h:38): -2 no teacher, no click; -1
    no teacher, click; [0, 1) the teacher's q, no click; [1, 2] 1 + q,
    click."""
    x0 = ctx.input("X")
    x = x0.float().reshape(-1)
    label = ctx.input("Label").float().reshape(-1)
    relu_x = torch.clamp(x, min=0.0)
    softplus = torch.log1p(torch.exp(-torch.abs(x)))
    bce = relu_x + softplus
    bce_click = relu_x - x + softplus
    loss = torch.where(
        label < -1.0, bce,
        torch.where(label < 0.0, bce_click,
                    torch.where(label < 1.0,
                                bce + relu_x - x * label + softplus,
                                bce_click + relu_x - x * (label - 1.0)
                                + softplus)))
    ctx.set_output("Y", loss.reshape(-1, 1).to(x0.dtype))


@register_op("sampling_id")
def sampling_id_op(ctx: OpContext):
    """reference: sampling_id_op.cc — one column a row of X [N, K] drawn
    with the row's probabilities → Out [N] int32: the Gumbel-max of
    log(max(x, 1e-20)), the noise from the op's generator (the JAX
    package's ``jax.random.categorical`` draws the same law)."""
    x = ctx.input("X")
    u = torch.rand(x.shape, generator=ctx.rng(), device=x.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    logp = torch.log(torch.clamp(x.float(), min=1e-20))
    ids = torch.argmax(logp - torch.log(-torch.log(u)), dim=-1)
    ctx.set_output("Out", ids.to(torch.int32))


@register_op("random_crop")
def random_crop_op(ctx: OpContext):
    """reference: random_crop_op.cc — the trailing dims cut to ``shape``
    at an offset drawn on the device from the op's generator, uniform in
    [0, size - crop] a dim (the centre under ``is_test``); the crop is a
    gather a dim, so no offset reaches the host."""
    x = ctx.input("X")
    shape = [int(s) for s in ctx.attr("shape")]
    lead = x.dim() - len(shape)
    out = x
    for i, s in enumerate(shape):
        dim = lead + i
        limit = x.shape[dim] - s
        if ctx.is_test or limit <= 0:
            start = torch.full((), max(limit, 0) // 2, device=x.device)
        else:
            start = torch.randint(0, limit + 1, (), generator=ctx.rng(),
                                  device=x.device)
        idx = start + torch.arange(s, device=x.device)
        view = [1] * out.dim()
        view[dim] = s
        size = list(out.shape)
        size[dim] = s
        out = out.gather(dim, idx.reshape(view).expand(size))
    ctx.set_output("Out", out)


@register_op("spectral_norm")
def spectral_norm_op(ctx: OpContext):
    """reference: spectral_norm_op.cc — Weight / σ, σ the top singular
    value of Weight as a [dim, rest] matrix by ``power_iters`` rounds of
    power iteration from U, V; UOut, VOut the vectors after them. The
    gradient runs through the iteration, as the JAX package's does."""
    w = ctx.input("Weight")
    u, v = ctx.input("U").reshape(-1), ctx.input("V").reshape(-1)
    dim = int(ctx.attr("dim", 0))
    eps = float(ctx.attr("eps", 1e-12))
    perm = (dim,) + tuple(i for i in range(w.dim()) if i != dim)
    mat = w.permute(perm).reshape(w.shape[dim], -1)
    for _ in range(int(ctx.attr("power_iters", 1))):
        v = mat.t() @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ (mat @ v)
    ctx.set_output("Out", w / sigma)
    ctx.set_output("UOut", u)
    ctx.set_output("VOut", v)


@register_op("conv_shift")
def conv_shift_op(ctx: OpContext):
    """reference: conv_shift_op.cc — circular correlation of X [B, D] with
    Y [B, M] (M odd), the NTM shift → [B, D]."""
    x, y = ctx.input("X"), ctx.input("Y")
    m = y.shape[1]
    out = torch.zeros_like(x)
    for j in range(m):
        out = out + torch.roll(x, m // 2 - j, dims=1) * y[:, j:j + 1]
    ctx.set_output("Out", out)


@register_op("similarity_focus")
def similarity_focus_op(ctx: OpContext):
    """reference: similarity_focus_op.cc — for each channel in
    ``indexes`` of X [B, C, H, W] (``axis`` 1 only, as in the JAX
    package), 1 at every (h, w) of that channel that is its row's or its
    column's maximum; 0 elsewhere."""
    x = ctx.input("X")
    if int(ctx.attr("axis", 1)) != 1:
        raise NotImplementedError("similarity_focus: only axis=1 (channel)")
    channel = torch.arange(x.shape[1], device=x.device)[None, :, None, None]
    out = torch.zeros_like(x)
    for ci in (int(i) for i in ctx.attr("indexes")):
        ch = x[:, ci]
        hit = (ch == torch.amax(ch, dim=2, keepdim=True)) \
            | (ch == torch.amax(ch, dim=1, keepdim=True))
        out = out + hit.to(x.dtype)[:, None] * (channel == ci)
    ctx.set_output("Out", torch.clamp(out, max=1.0))


@register_op("fused_embedding_seq_pool")
def fused_embedding_seq_pool_op(ctx: OpContext):
    """reference: fused_embedding_seq_pool_op.cc — W's rows at Ids [B, L]
    (+ Length) summed over L → [B, D]; rows past a row's length count 0.
    The gather's gradient sums repeated ids in one order every run
    (``nn_ops._Lookup``)."""
    w = ctx.input("W")
    ids = ctx.input("Ids")
    if ids.dim() == 3 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    ids = ids.long()
    emb = _Lookup.apply(w, ids.clamp(0, w.shape[0] - 1))   # [B, L, D]
    length = ctx.input("Length")
    if length is not None:
        keep = torch.arange(ids.shape[1], device=ids.device)[None, :] \
            < length.reshape(-1, 1)
        emb = torch.where(keep[..., None], emb, 0.0)
    ctx.set_output("Out", emb.sum(dim=1))


@register_op("max_pool3d_with_index")
def max_pool3d_with_index_op(ctx: OpContext):
    """reference: pool_with_index_op.cc, the 3-D variant — Out and Mask,
    the int32 position ``d * H * W + h * W + w`` of each window's maximum
    (the first on ties); no padding."""
    x = ctx.input("X")
    kd, kh, kw = ctx.attr("ksize", [2, 2, 2])
    sd, sh, sw = ctx.attr("strides", [kd, kh, kw])
    n, c, d, h, w = x.shape
    od, oh, ow = (d - kd) // sd + 1, (h - kh) // sh + 1, (w - kw) // sw + 1
    vals = x.unfold(2, kd, sd).unfold(3, kh, sh).unfold(4, kw, sw)
    vals = vals.reshape(n, c, od, oh, ow, kd * kh * kw)
    out = torch.amax(vals, dim=-1)
    arg = torch.argmax(vals, dim=-1)
    dev = x.device
    gz = (torch.arange(od, device=dev) * sd)[:, None, None] + arg // (kh * kw)
    gy = (torch.arange(oh, device=dev) * sh)[:, None] + (arg // kw) % kh
    gx = torch.arange(ow, device=dev) * sw + arg % kw
    ctx.set_output("Out", out)
    ctx.set_output("Mask", (gz * h * w + gy * w + gx).to(torch.int32))


@register_op("fill")
def fill_op(ctx: OpContext):
    """reference: fill_op.cc — Out of ``shape`` and ``dtype`` holding the
    ``value`` list, made once a device and kept on the op (a host copy
    per step would not capture)."""
    shape = [int(s) for s in ctx.attr("shape")]
    dtype = to_torch_dtype(ctx.attr("dtype", "float32"))
    value = ctx.attr("value")
    ctx.set_output("Out", _cached(ctx, (ctx.device, tuple(shape), dtype),
                                  lambda: torch.tensor(value, dtype=dtype)
                                  .reshape(shape).to(ctx.device)))


def _tree_patch_matrices(edges, max_nodes, max_depth):
    """Host-side tree2col (reference: operators/math/tree2col.cc
    construct_patch): a sample's [3, Nmax, Nmax] coefficients (eta_l,
    eta_r, eta_t of each node in each root's patch) from its directed
    parent → child edges, 1-based; a row with a zero ends the list."""
    out = np.zeros((edges.shape[0], 3, max_nodes, max_nodes), np.float32)
    for b in range(edges.shape[0]):
        adj = {}
        n_nodes = 1
        for u, v in edges[b]:
            u, v = int(u), int(v)
            if u == 0 or v == 0:
                break
            adj.setdefault(u, []).append(v)
            n_nodes += 1
        for root in range(1, n_nodes + 1):
            # the reference's stack traversal, depth below max_depth
            visited = {root}
            stack = [(root, 1, 1, 0)]  # (node, index, siblings, depth)
            patch = [(root, 1, 1, 0)]
            while stack:
                node, _, _, depth = stack[-1]
                progressed = False
                kids = adj.get(node, [])
                for i, v in enumerate(kids):
                    if v not in visited and depth + 1 < max_depth:
                        visited.add(v)
                        stack.append((v, i, len(kids), depth + 1))
                        patch.append((v, i + 1, len(kids), depth + 1))
                        progressed = True
                if not progressed:
                    stack.pop()
            for node, idx, pclen, depth in patch:
                eta_t = (max_depth - depth) / max_depth
                tmp = 0.5 if pclen == 1 else (idx - 1.0) / (pclen - 1.0)
                eta_l = (1.0 - eta_t) * tmp
                eta_r = (1.0 - eta_t) * (1.0 - eta_l)
                # the Filter's dim 1 holds (l, r, t) (tree2col.cc)
                out[b, 0, root - 1, node - 1] += eta_l
                out[b, 1, root - 1, node - 1] += eta_r
                out[b, 2, root - 1, node - 1] += eta_t
    return out


@register_op("tree_conv")
def tree_conv_op(ctx: OpContext):
    """Tree-based convolution (reference: tree_conv_op.cc, TBCNN).
    NodesVector [B, Nmax, F], EdgeSet [B, E, 2] (1-based node ids, (0, 0)
    rows pad), Filter [F, 3, output_size, num_filters] → Out
    [B, Nmax, output_size, num_filters]. The patch coefficients come from
    a host copy of the edges (no gradient, as in the reference); the two
    products run where the nodes are."""
    nodes, filt = ctx.input("NodesVector"), ctx.input("Filter")
    edges = ctx.input("EdgeSet").detach().cpu().numpy()
    _, nmax, _ = nodes.shape
    coefs = torch.from_numpy(_tree_patch_matrices(
        edges, nmax, int(ctx.attr("max_depth", 2)))).to(nodes.device)
    col = torch.einsum("bdnm,bmf->bdnf", coefs, nodes.float())
    out = torch.einsum("bdnf,fdok->bnok", col, filt.float())
    ctx.set_output("Out", out.to(nodes.dtype))


def _mul32(h, k):
    """(h * k) mod 2^32 for h < 2^32, by k's 16-bit halves: no product
    reaches 2^49, so int64 never overflows."""
    lo = h * (k & 0xFFFF)
    hi = ((h * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(h):
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


@register_op("hash")
def hash_op(ctx: OpContext):
    """reference: hash_op.cc — each id row of X [N, D] hashed into
    [0, mod_by), once a seed → Out [N, num_hash, 1] int32. The JAX
    package's hash (the reference uses xxhash): a murmur3-style uint32
    finalizer folded over the row, bit for bit."""
    x = ctx.input("X").long() & _MASK32
    mod_by = int(ctx.attr("mod_by", 100000))
    outs = []
    for seed in range(int(ctx.attr("num_hash", 1))):
        h = torch.full(x.shape[:1], seed + 1, dtype=torch.long,
                       device=x.device)
        for j in range(x.shape[1]):
            h = _mix32(h ^ _mix32((x[:, j] + 0x9E3779B9) & _MASK32))
        outs.append((h % mod_by).to(torch.int32))
    ctx.set_output("Out", torch.stack(outs, dim=1)[:, :, None])
