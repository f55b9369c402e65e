# ported from paddle_tpu/ops/sequence_ops.py
"""Sequence ops over padded batches + lengths.

Fluid's ragged LoD tensors (``framework/lod_tensor.h:58-110``) become, as
in the JAX package, **padded [B, T, ...] tensors + an int Length vector
[B]**: each op takes X and Length and computes the reference op's
per-sequence result. Also here, as sequence ops, the three of the JAX
package's ``extra_ops.py`` that work on time: ``sequence_conv``,
``sequence_reshape`` and ``lod_reset``.

Nothing here reads a device value on the host: the lengths become masks
on the device (a captured step holds every op). Integer outputs take the
JAX package's dtypes (it runs with 64-bit types off): the lengths an op
computes are int32; ``sequence_mask`` gives its ``out_dtype``.
"""

from __future__ import annotations

import torch

from ..core.dtypes import to_torch_dtype
from ..core.registry import OpContext, register_op
from .tensor_ops import _cached

# the fill of masked positions in a max pool (the JAX op's constant)
_MAX_FILL = -3.4e38


def _mask(length, maxlen, device=None):
    """[B, maxlen] bool, True where t < length_b."""
    t = torch.arange(maxlen, device=length.device if device is None
                     else device)
    return t[None, :] < length.reshape(-1, 1)


def _bcast(m, x):
    """A [B, T] mask viewed against x [B, T, ...]."""
    return m.reshape(m.shape + (1,) * (x.dim() - 2))


def _full_length(x):
    return torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                      device=x.device)


@register_op("sequence_mask")
def sequence_mask_op(ctx: OpContext):
    """reference: operators/sequence_ops/sequence_mask_op.cc."""
    length = ctx.input("X").reshape(-1)
    maxlen = ctx.attr("maxlen", -1)
    if maxlen is None or maxlen <= 0:
        raise ValueError(
            "sequence_mask needs a static maxlen attr (static shapes)")
    dtype = to_torch_dtype(ctx.attr("out_dtype", "int64"))
    ctx.set_output("Y", _mask(length, maxlen).to(dtype))


@register_op("sequence_pool")
def sequence_pool_op(ctx: OpContext):
    """reference: sequence_pool_op.cc — pooltype in {sum, average, sqrt,
    max, last, first}. X: [B, T, ...], Length: [B]; without Length every
    row is T long (padding included). ``max`` splits the gradient evenly
    among tied maxima (``torch.amax``, as ``jnp.max``); a row of length 0
    pools to -3.4e38."""
    x = ctx.input("X")
    length = ctx.input("Length")
    ptype = ctx.attr("pooltype", "average").lower()
    B, T = x.shape[0], x.shape[1]
    length = _full_length(x) if length is None else length.reshape(-1)
    m = _bcast(_mask(length, T, x.device), x)
    denom = torch.clamp(length.to(x.dtype), min=1).reshape(
        (B,) + (1,) * (x.dim() - 2))
    if ptype == "sum":
        out = torch.sum(x * m.to(x.dtype), dim=1)
    elif ptype == "average":
        out = torch.sum(x * m.to(x.dtype), dim=1) / denom
    elif ptype == "sqrt":
        out = torch.sum(x * m.to(x.dtype), dim=1) / torch.sqrt(denom)
    elif ptype == "max":
        out = torch.amax(torch.where(m, x, torch.full_like(x, _MAX_FILL)),
                         dim=1)
    elif ptype == "last":
        idx = torch.clamp(length - 1, min=0).to(torch.int64)
        out = torch.take_along_dim(
            x, idx.reshape((B, 1) + (1,) * (x.dim() - 2)), dim=1).squeeze(1)
    elif ptype == "first":
        out = x[:, 0]
    else:
        raise ValueError("unknown pooltype %r" % ptype)
    ctx.set_output("Out", out)


@register_op("sequence_softmax")
def sequence_softmax_op(ctx: OpContext):
    """reference: sequence_softmax_op.cc — softmax within each sequence,
    0 at the padding."""
    x = ctx.input("X")
    length = ctx.input("Length")
    if length is None:
        ctx.set_output("Out", torch.softmax(x, dim=1))
        return
    m = _bcast(_mask(length.reshape(-1), x.shape[1], x.device), x)
    probs = torch.softmax(torch.where(m, x, torch.full_like(x, -1e9)), dim=1)
    ctx.set_output("Out", torch.where(m, probs, torch.zeros_like(probs)))


@register_op("sequence_reverse")
def sequence_reverse_op(ctx: OpContext):
    """reference: sequence_reverse_op.h — reverse each sequence's valid
    prefix, padding stays in place."""
    x = ctx.input("X")
    length = ctx.input("Length")
    if length is None:
        ctx.set_output("Y", torch.flip(x, dims=[1]))
        return
    B, T = x.shape[0], x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    L = length.reshape(-1, 1).to(torch.int64)
    idx = torch.where(t < L, L - 1 - t, t)
    ctx.set_output("Y", torch.take_along_dim(
        x, idx.reshape((B, T) + (1,) * (x.dim() - 2)), dim=1))


def _expand_time(x, y):
    """X [B, ...] repeated over Y's time dim: [B, T_y, ...]."""
    return x[:, None].expand((x.shape[0], y.shape[1]) + tuple(x.shape[1:]))


@register_op("sequence_expand")
def sequence_expand_op(ctx: OpContext):
    """reference: sequence_expand_op.cc with ref_level reduced to the
    padded form: X [B, D] tiled over Y's time dim → [B, T, D]."""
    ctx.set_output("Out", _expand_time(ctx.input("X"), ctx.input("Y")))


@register_op("sequence_expand_as")
def sequence_expand_as_op(ctx: OpContext):
    ctx.set_output("Out", _expand_time(ctx.input("X"), ctx.input("Y")))


@register_op("sequence_concat")
def sequence_concat_op(ctx: OpContext):
    """Concatenate along time: [B,T1,D]+[B,T2,D] → [B,T1+T2,D]. With
    Lengths each row's valid prefixes are packed one after another
    (LengthOut their sum), zeros after."""
    xs = ctx.inputs("X")
    lengths = ctx.inputs("Length") if ctx.has_input("Length") else None
    if not lengths:
        ctx.set_output("Out", torch.cat(xs, dim=1))
        return
    B = xs[0].shape[0]
    T_out = sum(x.shape[1] for x in xs)
    D = tuple(xs[0].shape[2:])
    dev = xs[0].device
    out = torch.zeros((B, T_out) + D, dtype=xs[0].dtype, device=dev)
    t_total = torch.zeros((B,), dtype=torch.int32, device=dev)
    b_idx = torch.arange(B, device=dev)[:, None]
    for x, l in zip(xs, lengths):
        l = l.reshape(-1)
        T = x.shape[1]
        src_t = torch.arange(T, device=dev)[None, :]
        valid = src_t < l[:, None]
        # each valid position lands at its row's running offset; the
        # invalid ones add zeros into the last slot
        tgt = torch.where(valid, t_total[:, None].to(torch.int64) + src_t,
                          T_out - 1)
        vals = torch.where(_bcast(valid, x), x, torch.zeros_like(x))
        out = out + torch.zeros_like(out).index_put(
            (b_idx.expand(B, T).reshape(-1), tgt.reshape(-1)),
            vals.reshape((B * T,) + D), accumulate=True)
        t_total = t_total + l.to(torch.int32)
    ctx.set_output("Out", out)
    ctx.set_output("LengthOut", t_total)


@register_op("sequence_pad")
def sequence_pad_op(ctx: OpContext):
    """reference: sequence_pad_op.cc — X is already padded [B, T, ...];
    re-pads to ``padded_length`` with PadValue and emits Length."""
    x = ctx.input("X")
    length = ctx.input("Length")
    pad_value = ctx.input("PadValue")
    target = ctx.attr("padded_length", -1)
    B, T = x.shape[0], x.shape[1]
    if target is None or target <= 0:
        target = T
    pv = pad_value.reshape(()).to(x.dtype) if pad_value is not None \
        else torch.zeros((), dtype=x.dtype, device=x.device)
    if length is None:
        length = _full_length(x)
    m = _bcast(_mask(length.reshape(-1), T, x.device), x)
    x = torch.where(m, x, pv)
    if target > T:
        x = torch.cat([x, pv.expand((B, target - T) + tuple(x.shape[2:]))],
                      dim=1)
    else:
        x = x[:, :target]
    ctx.set_output("Out", x)
    ctx.set_output("Length", length.reshape(-1))


@register_op("sequence_unpad")
def sequence_unpad_op(ctx: OpContext):
    """reference: sequence_unpad_op.cc — zeroes the padding (the output
    stays padded: a ragged tensor has no static shape)."""
    x = ctx.input("X")
    m = _bcast(_mask(ctx.input("Length").reshape(-1), x.shape[1], x.device),
               x)
    ctx.set_output("Out", torch.where(m, x, torch.zeros_like(x)))


@register_op("sequence_erase")
def sequence_erase_op(ctx: OpContext):
    """reference: sequence_erase_op.cc — drop the listed tokens and compact
    each row left, 0 after. X: [B, T] int."""
    x = ctx.input("X")
    T = x.shape[1]
    keep = torch.ones_like(x, dtype=torch.bool)
    for tok in ctx.attr("tokens", []):
        keep = keep & (x != tok)
    # a stable sort of "dropped" puts the kept tokens first, in order
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    compacted = torch.take_along_dim(x, order, dim=1)
    new_len = keep.sum(dim=1, dtype=torch.int32)
    m = _mask(new_len, T, x.device)
    ctx.set_output("Out", torch.where(m, compacted,
                                      torch.zeros_like(compacted)))
    ctx.set_output("Length", new_len)


@register_op("sequence_enumerate")
def sequence_enumerate_op(ctx: OpContext):
    """reference: sequence_enumerate_op.cc — sliding windows of win_size,
    ``pad_value`` past the end. [B, T] → [B, T, win_size]."""
    x = ctx.input("X")
    win = int(ctx.attr("win_size"))
    pad = ctx.attr("pad_value", 0)
    B, T = x.shape
    padded = torch.cat([x, torch.full((B, win - 1), pad, dtype=x.dtype,
                                      device=x.device)], dim=1)
    ctx.set_output("Out", torch.stack([padded[:, i:i + T]
                                       for i in range(win)], dim=-1))


@register_op("sequence_slice")
def sequence_slice_op(ctx: OpContext):
    """reference: sequence_slice_op.cc — each row's [offset, offset +
    length), padded to ``out_maxlen`` (else T) with zeros."""
    x = ctx.input("X")
    offset = ctx.input("Offset").reshape(-1)
    length = ctx.input("Length").reshape(-1)
    B, T = x.shape[0], x.shape[1]
    out_T = ctx.attr("out_maxlen", 0) or T
    t = torch.arange(out_T, device=x.device)
    idx = torch.clamp(offset[:, None].to(torch.int64) + t[None, :], 0, T - 1)
    g = torch.take_along_dim(x, idx.reshape((B, out_T) + (1,) * (x.dim() - 2)),
                             dim=1)
    m = _bcast(_mask(length, out_T, x.device), g)
    ctx.set_output("Out", torch.where(m, g, torch.zeros_like(g)))


@register_op("sequence_scatter")
def sequence_scatter_op(ctx: OpContext):
    """reference: sequence_scatter_op.cc — per-row scatter-add of Updates
    [B, K] at Ids [B, K] into X [B, T]."""
    x = ctx.input("X")
    ids = ctx.input("Ids").to(torch.int64)
    upd = ctx.input("Updates")
    b_idx = torch.arange(x.shape[0], device=x.device)[:, None].expand(
        ids.shape)
    ctx.set_output("Out", x.index_put(
        (b_idx.reshape(-1), ids.reshape(-1)), upd.reshape(-1).to(x.dtype),
        accumulate=True))


@register_op("im2sequence")
def im2sequence_op(ctx: OpContext):
    """reference: im2sequence_op.cc — image patches to a sequence
    [N, oh·ow, C·kh·kw]."""
    x = ctx.input("X")  # NCHW
    kh, kw = ctx.attr("kernels")
    sh, sw = ctx.attr("strides", [1, 1])
    n, c, h, w = x.shape
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1
    patches = [x[:, :, i:i + sh * oh:sh, j:j + sw * ow:sw]
               for i in range(kh) for j in range(kw)]
    stacked = torch.stack(patches, dim=2)  # [N, C, kh*kw, oh, ow]
    ctx.set_output("Out", stacked.reshape(n, c * kh * kw, oh * ow)
                   .transpose(1, 2))


@register_op("row_conv")
def row_conv_op(ctx: OpContext):
    """reference: row_conv_op.cc — lookahead row convolution over
    [B, T, D] with Filter [future_ctx + 1, D]."""
    x = ctx.input("X")
    w = ctx.input("Filter")
    B, T, D = x.shape
    out = torch.zeros_like(x)
    for k in range(w.shape[0]):
        shifted = x if k == 0 else torch.cat(
            [x[:, k:], x.new_zeros((B, min(k, T), D))], dim=1)[:, :T]
        out = out + shifted * w[k][None, None, :]
    ctx.set_output("Out", out)


@register_op("sequence_conv")
def sequence_conv_op(ctx: OpContext):
    """reference: operators/sequence_conv_op.cc — conv over time with a
    context window. X [B, T, D] (+ Length: the padding is zeroed first, so
    no window reads past a row's end), Filter [ctx_len·D, filters]."""
    x = ctx.input("X")
    filt = ctx.input("Filter")
    length = ctx.input("Length")
    ctx_len = int(ctx.attr("contextLength", 3))
    ctx_start = int(ctx.attr("contextStart", -(ctx_len // 2)))
    t = x.shape[1]
    if length is not None:
        m = _mask(length.reshape(-1), t, x.device)
        x = torch.where(m[..., None], x, torch.zeros_like(x))
    pos = torch.arange(t, device=x.device)
    cols = []
    for k in range(ctx_len):
        off = ctx_start + k
        inside = ((pos + off >= 0) & (pos + off < t)).to(x.dtype)
        cols.append(torch.roll(x, -off, dims=1) * inside[None, :, None])
    ctx.set_output("Out", torch.matmul(torch.cat(cols, dim=-1), filt))


@register_op("sequence_reshape")
def sequence_reshape_op(ctx: OpContext):
    """reference: operators/sequence_reshape_op.cc — re-chunk the feature
    dim: [B, T, D] → [B, T·D/new_dim, new_dim]; OutLength = Length ·
    D / new_dim."""
    x = ctx.input("X")
    new_dim = int(ctx.attr("new_dim"))
    b, t, d = x.shape
    ctx.set_output("Out", x.reshape(b, t * d // new_dim, new_dim))
    length = ctx.input("Length")
    if length is not None:
        ctx.set_output("OutLength", torch.div(length * d, new_dim,
                                              rounding_mode="floor"))


@register_op("lod_reset")
def lod_reset_op(ctx: OpContext):
    """reference: operators/lod_reset_op.cc — under padded+Length this
    swaps the Length descriptor: the data passes through, the new lengths
    come from Y, else from the ``target_lod`` offsets (a kept constant)."""
    ctx.set_output("Out", ctx.input("X"))
    y = ctx.input("Y")
    if y is not None:
        ctx.set_output("OutLength", y)
        return
    tl = [int(v) for v in ctx.attr("target_lod", [])]
    lens = _cached(ctx, ("target_lod", ctx.device), lambda: torch.tensor(
        [b - a for a, b in zip(tl, tl[1:])], dtype=torch.int32,
        device=ctx.device), slot="OutLength")
    ctx.set_output("OutLength", lens)
