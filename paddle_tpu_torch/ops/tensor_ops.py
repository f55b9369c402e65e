# ported from paddle_tpu/ops/tensor_ops.py
"""Tensor manipulation, fill, random and selection ops.

Fluid equivalents live across ``operators/reshape_op.cc``,
``fill_constant_op.cc``, ``uniform_random_op.cc``, ``dropout_op.cc`` etc.

Integer outputs take the JAX package's dtypes (it runs with 64-bit types
off): ``shape``, ``arg_max``, ``arg_min``, ``argsort``'s indices and
``randint`` are int32. Nothing here reads a device value on the host but
``range`` and ``linspace``, whose output size is the value of their
inputs (the JAX package reads them while tracing), and ``reshape`` with a
``Shape`` input.

Randomness: the JAX package derives one threefry key per op
(``TraceContext.op_rng``); torch cannot redraw threefry, so here each
stochastic op draws from its own ``torch.Generator`` on the run's device
(:meth:`OpContext.rng`), seeded from (seed attr or ``program.random_seed``,
step index, op position). The draws are deterministic for a seed but are
not the JAX package's bits: parity with it holds at dropout 0, and with
dropout on the tests check the keep rate and the ``is_test`` identity.
Initial weights are carried across as arrays (``paddle_tpu_torch.io``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtypes import to_torch_dtype
from ..core.registry import OpContext, register_op


def _resolve_shape(shape, x=None):
    """Resolve a Fluid shape attr (may contain -1 and 0) against input x."""
    shape = list(shape)
    if x is not None:
        for i, s in enumerate(shape):
            if s == 0 and i < x.dim():  # 0 means "copy from input" in fluid reshape
                shape[i] = x.shape[i]
    return shape


def _cached(ctx: OpContext, key, make, slot="Out"):
    """A constant of the op for its output ``slot``, made once per key (its
    device among it) and kept on the op: a tensor made from host values
    costs a host-to-device copy, which a captured step cannot hold. The
    kept tensor is shared by every run, but a training step writes a
    persistable var's tensor in place (the optimizers' row updates, the
    captured step's write-back), so where the output is persistable (a
    parameter that a startup program fills) the op hands out a copy.
    ``slot=None`` returns the kept value itself, for a constant the op
    computes with rather than outputs; so does an op run outside a
    program (no block)."""
    cache = ctx.op.__dict__.setdefault("_constant_cache", {})
    out = cache.get(key)
    if out is None:
        out = cache[key] = make()
    block = ctx.op.block
    if slot is None or block is None:
        return out
    var = block._find_var_recursive(ctx.output_name(slot))
    return out.clone() if var is not None and var.persistable else out


def _set_xshape(ctx: OpContext, x):
    if ctx.has_output("XShape"):
        ctx.set_output("XShape", x.new_zeros((0,) + tuple(x.shape)))


@register_op("reshape", "reshape2")
def reshape_op(ctx: OpContext):
    x = ctx.input("X")
    shape_tensor = ctx.input("Shape") if ctx.has_input("Shape") else None
    if shape_tensor is not None:
        shape = [int(s) for s in shape_tensor.tolist()]
    else:
        shape = _resolve_shape(ctx.attr("shape"), x)
    ctx.set_output("Out", x.reshape(shape))
    _set_xshape(ctx, x)


@register_op("squeeze", "squeeze2")
def squeeze_op(ctx: OpContext):
    """Drops the listed axes whose dim is 1 (an axis of another size is
    passed over, not an error), or every dim of 1 when ``axes`` is empty."""
    x = ctx.input("X")
    axes = ctx.attr("axes", [])
    if axes:
        axes = tuple(a % x.dim() for a in axes if x.shape[a % x.dim()] == 1)
        out = x.squeeze(axes) if axes else x
    else:
        out = x.squeeze()
    ctx.set_output("Out", out)
    _set_xshape(ctx, x)


@register_op("unsqueeze", "unsqueeze2")
def unsqueeze_op(ctx: OpContext):
    x = ctx.input("X")
    out = x
    for a in sorted(ctx.attr("axes")):
        out = out.unsqueeze(a)
    ctx.set_output("Out", out)
    _set_xshape(ctx, x)


@register_op("flatten", "flatten2")
def flatten_op(ctx: OpContext):
    """[d0, ..., dn] -> [d0·...·d(axis-1), d(axis)·...·dn]."""
    x = ctx.input("X")
    axis = ctx.attr("axis", 1)
    lead = math.prod(x.shape[:axis]) if axis > 0 else 1
    ctx.set_output("Out", x.reshape(lead, -1))
    _set_xshape(ctx, x)


@register_op("transpose", "transpose2")
def transpose_op(ctx: OpContext):
    x = ctx.input("X")
    ctx.set_output("Out", x.permute(*ctx.attr("axis")))
    _set_xshape(ctx, x)


@register_op("split")
def split_op(ctx: OpContext):
    x = ctx.input("X")
    axis = ctx.attr("axis", 0)
    num = ctx.attr("num", 0)
    sections = ctx.attr("sections", [])
    if sections:
        outs = torch.split(x, list(sections), dim=axis)
    else:
        if x.shape[axis] % num:
            raise ValueError("split: dim %d of size %d does not divide into "
                             "%d equal parts" % (axis, x.shape[axis], num))
        outs = torch.split(x, x.shape[axis] // num, dim=axis)
    ctx.set_outputs("Out", outs)


@register_op("stack")
def stack_op(ctx: OpContext):
    ctx.set_output("Y", torch.stack(ctx.inputs("X"), ctx.attr("axis", 0)))


@register_op("unstack")
def unstack_op(ctx: OpContext):
    ctx.set_outputs("Y", torch.unbind(ctx.input("X"), ctx.attr("axis", 0)))


@register_op("slice")
def slice_op(ctx: OpContext):
    """``Input[starts:ends]`` along ``axes``: a negative start or end counts
    from the end of its dim, and both clamp to [0, dim]."""
    x = ctx.input("Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(ctx.attr("axes"), ctx.attr("starts"), ctx.attr("ends")):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    ctx.set_output("Out", x[tuple(idx)])


@register_op("strided_slice")
def strided_slice_op(ctx: OpContext):
    """``Input[start:end:stride]`` along ``axes`` with Python's slice rules
    (a negative stride walks backwards; torch slices take positive steps
    only, so that one reads the flipped dim)."""
    x = ctx.input("Input")
    out = x
    for a, s, e, st in zip(ctx.attr("axes"), ctx.attr("starts"),
                           ctx.attr("ends"), ctx.attr("strides")):
        dim = x.shape[a]
        r = range(*slice(s, e, st).indices(dim))
        idx = [slice(None)] * x.dim()
        if st > 0 or not r:
            idx[a] = slice(r.start, r.start + len(r) * st, st) if r \
                else slice(0, 0)
            out = out[tuple(idx)]
        else:
            first = dim - 1 - r.start
            idx[a] = slice(first, first + len(r) * -st, -st)
            out = torch.flip(out, (a,))[tuple(idx)]
    ctx.set_output("Out", out)


@register_op("gather")
def gather_op(ctx: OpContext):
    """Rows of ``X`` at the flattened ``Index`` (a negative index counts from
    the end). Its gradient sums the rows of a repeated index (on the card
    with atomic adds). An index out of [-rows, rows) raises where the JAX
    package returns a row of NaN."""
    x, index = ctx.input("X"), ctx.input("Index")
    ctx.set_output("Out", x[index.reshape(-1)])


@register_op("gather_nd")
def gather_nd_op(ctx: OpContext):
    """``X[Index[..., 0], ..., Index[..., k-1]]``: out is Index.shape[:-1]
    + X.shape[k:]."""
    x, index = ctx.input("X"), ctx.input("Index").long()
    ctx.set_output("Out", x[tuple(index.movedim(-1, 0))])


def _last_of_run(ids):
    """For each position of ``ids``, the position of the last occurrence
    of its value, with no host read: a stable sort, then a reversed
    running minimum of the run ends."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    end = torch.ones_like(sid, dtype=torch.bool)
    end[:-1] = sid[:-1] != sid[1:]
    pos = torch.arange(n, device=ids.device)
    run_end = torch.flip(torch.cummin(torch.flip(
        torch.where(end, pos, n), (0,)), 0).values, (0,))
    last = torch.empty_like(order)
    last[order] = order[run_end]
    return last


@register_op("scatter")
def scatter_op(ctx: OpContext):
    """``X`` with rows ``Ids`` replaced by ``Updates`` (``overwrite``) or
    with ``Updates`` added to them. Overwriting keeps the last of a
    repeated id, as XLA's scatter does on the CPU: every write to one row
    carries the last occurrence's update (the others detached), so the
    writes agree and the result does not depend on their order, and only
    the last occurrence gets a gradient. Adding is
    ``index_put(accumulate=True)``, which CUDA sums by a sort, not by
    atomics."""
    x, updates = ctx.input("X"), ctx.input("Updates")
    ids = ctx.input("Ids").reshape(-1).long()
    ids = torch.where(ids < 0, ids + x.shape[0], ids)
    if ctx.attr("overwrite", True):
        last = _last_of_run(ids)
        keep = (last == torch.arange(ids.shape[0], device=ids.device))
        keep = keep.reshape((-1,) + (1,) * (updates.dim() - 1))
        vals = torch.where(keep, updates, updates[last].detach())
        out = x.index_put((ids,), vals.to(x.dtype))
    else:
        out = x.index_put((ids,), updates.to(x.dtype), accumulate=True)
    ctx.set_output("Out", out)


@register_op("expand")
def expand_op(ctx: OpContext):
    """``jnp.tile`` of X by ``expand_times``."""
    ctx.set_output("Out", torch.tile(ctx.input("X"),
                                     tuple(ctx.attr("expand_times"))))


@register_op("expand_as")
def expand_as_op(ctx: OpContext):
    x, target = ctx.input("X"), ctx.input("target_tensor")
    ctx.set_output("Out", torch.tile(x, tuple(
        t // s for s, t in zip(x.shape, target.shape))))


@register_op("tile")
def tile_op(ctx: OpContext):
    ctx.set_output("Out", torch.tile(ctx.input("X"),
                                     tuple(ctx.attr("repeat_times"))))


def _torch_pad(pairs):
    """``F.pad``'s flat list (last dim first) of per-dim (before, after)
    pairs."""
    return tuple(q for p in reversed(pairs) for q in p)


@register_op("pad")
def pad_op(ctx: OpContext):
    x = ctx.input("X")
    p = ctx.attr("paddings")
    pairs = [(p[2 * i], p[2 * i + 1]) for i in range(x.dim())]
    ctx.set_output("Out", F.pad(x, _torch_pad(pairs),
                                value=ctx.attr("pad_value", 0.0)))


_PAD2D_MODES = {"constant": "constant", "reflect": "reflect",
                "edge": "replicate"}


@register_op("pad2d")
def pad2d_op(ctx: OpContext):
    """Pads H and W (``paddings`` = top, bottom, left, right) with a
    constant, a reflection or the edge, NCHW or NHWC (``data_format``;
    the JAX package always pads dims 2 and 3)."""
    x = ctx.input("X")
    p = ctx.attr("paddings", [0, 0, 0, 0])
    mode = _PAD2D_MODES[ctx.attr("mode", "constant")]
    last = ctx.attr("data_format", "NCHW") == "NHWC"
    if last:
        x = x.movedim(-1, 1)
    pad = (p[2], p[3], p[0], p[1])
    out = F.pad(x, pad, value=ctx.attr("pad_value", 0.0)) \
        if mode == "constant" else F.pad(x, pad, mode=mode)
    ctx.set_output("Out", out.movedim(1, -1) if last else out)


@register_op("pad_constant_like")
def pad_constant_like_op(ctx: OpContext):
    """Y padded at the end of each dim up to X's shape."""
    x, y = ctx.input("X"), ctx.input("Y")
    pairs = [(0, xs - ys) for xs, ys in zip(x.shape, y.shape)]
    ctx.set_output("Out", F.pad(y, _torch_pad(pairs),
                                value=ctx.attr("pad_value", 0.0)))


@register_op("crop")
def crop_op(ctx: OpContext):
    x = ctx.input("X")
    idx = tuple(slice(o, o + s) for o, s in zip(ctx.attr("offsets"),
                                                ctx.attr("shape")))
    ctx.set_output("Out", x[idx])


@register_op("reverse")
def reverse_op(ctx: OpContext):
    ctx.set_output("Out", torch.flip(ctx.input("X"),
                                     tuple(ctx.attr("axis"))))


@register_op("one_hot")
def one_hot_op(ctx: OpContext):
    """float32 [..., depth] rows (a trailing dim of 1 dropped), as
    ``jax.nn.one_hot``: an id outside [0, depth) gives a row of zeros. A
    comparison with an arange, not ``F.one_hot``, which asks the host for
    the ids' range."""
    ids = ctx.input("X")
    if ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    depth = ctx.attr("depth")
    ctx.set_output("Out", (ids[..., None] == torch.arange(
        depth, device=ids.device, dtype=ids.dtype)).float())


@register_op("shape")
def shape_op(ctx: OpContext):
    x = ctx.input("Input")
    shape = tuple(x.shape)
    ctx.set_output("Out", _cached(ctx, (x.device, shape), lambda: torch.tensor(
        shape, dtype=torch.int32).to(x.device)))


@register_op("argsort")
def argsort_op(ctx: OpContext):
    """Ascending and stable (``jnp.argsort``): equal values keep their
    order."""
    x = ctx.input("X")
    values, indices = torch.sort(x, dim=ctx.attr("axis", -1), stable=True)
    ctx.set_output("Indices", indices.int())
    ctx.set_output("Out", values)


@register_op("arg_max")
def arg_max_op(ctx: OpContext):
    """The first index of the largest value (``jnp.argmax``), int32."""
    ctx.set_output("Out", torch.argmax(ctx.input("X"),
                                       ctx.attr("axis", -1)).int())


@register_op("arg_min")
def arg_min_op(ctx: OpContext):
    ctx.set_output("Out", torch.argmin(ctx.input("X"),
                                       ctx.attr("axis", -1)).int())


@register_op("multiplex")
def multiplex_op(ctx: OpContext):
    """Row i of ``X[Ids[i]]``."""
    ids = ctx.input("Ids").reshape(-1).long()
    xs = torch.stack(ctx.inputs("X"), 0)  # [k, n, d]
    ctx.set_output("Out", xs[ids, torch.arange(xs.shape[1],
                                               device=xs.device)])


@register_op("is_empty")
def is_empty_op(ctx: OpContext):
    """A 0-d bool on X's device (a fill: no host read)."""
    x = ctx.input("X")
    ctx.set_output("Out", torch.full((), x.numel() == 0, dtype=torch.bool,
                                     device=x.device))


@register_op("concat")
def concat_op(ctx: OpContext):
    ctx.set_output("Out", torch.cat(ctx.inputs("X"), dim=ctx.attr("axis", 0)))


@register_op("top_k")
def top_k_op(ctx: OpContext):
    """The k largest values of the last axis and their int32 indices, in
    ``jax.lax.top_k``'s order: descending, the lower index first among
    equal values. ``torch.topk`` promises no order for ties (and its CPU
    and CUDA orders differ), and a bf16 softmax row ties often, which would
    move ``accuracy``; a stable descending sort keeps the reference's
    order. (The reference also orders -0.0 below +0.0; here they tie.)"""
    x = ctx.input("X")
    k = ctx.attr("k", 1)
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    ctx.set_output("Out", values[..., :k])
    ctx.set_output("Indices", indices[..., :k].int())


@register_op("where")
def where_op(ctx: OpContext):
    """``Condition ? X : Y`` elementwise (the ternary form; reference:
    operators/where_op.cc), broadcast as ``jnp.where`` does."""
    ctx.set_output("Out", torch.where(ctx.input("Condition"), ctx.input("X"),
                                      ctx.input("Y")))


# -- fill / init ops ----------------------------------------------------------


@register_op("fill_constant")
def fill_constant_op(ctx: OpContext):
    dtype = to_torch_dtype(ctx.attr("dtype", "float32"))
    ctx.set_output("Out", torch.full(list(ctx.attr("shape", [])),
                                     ctx.attr("value", 0.0), dtype=dtype,
                                     device=ctx.device))


@register_op("fill_constant_batch_size_like")
def fill_constant_batch_size_like_op(ctx: OpContext):
    x = ctx.input("Input")
    shape = list(ctx.attr("shape"))
    shape[ctx.attr("output_dim_idx", 0)] = x.shape[ctx.attr("input_dim_idx",
                                                            0)]
    dtype = to_torch_dtype(ctx.attr("dtype", "float32"))
    ctx.set_output("Out", torch.full(shape, ctx.attr("value", 0.0),
                                     dtype=dtype, device=x.device))


@register_op("assign")
def assign_op(ctx: OpContext):
    """A copy of X (its own storage: the scope may hold both names, and
    the row-wise optimizer updates write a table in place)."""
    ctx.set_output("Out", ctx.input("X").clone())


@register_op("fill_zeros_like")
def fill_zeros_like_op(ctx: OpContext):
    ctx.set_output("Out", torch.zeros_like(ctx.input("X")))


@register_op("assign_value")
def assign_value_op(ctx: OpContext):
    """The values list is a constant of the program (the Transformer's
    position table holds seq*d_model floats): it is converted and copied
    to the device once per (device, dtype), not on every step."""
    dtype = to_torch_dtype(ctx.attr("dtype", "float32"))
    values = ctx.attr("values")
    ctx.set_output("Out", _cached(
        ctx, (ctx.device, dtype, id(values)),
        lambda: torch.as_tensor(np.asarray(values)).to(
            device=ctx.device, dtype=dtype).reshape(ctx.attr("shape"))))


def _host_scalar(t):
    """A 1-element input read on the host (a sync on the card)."""
    return t.reshape(-1)[0].item()


@register_op("range")
def range_op(ctx: OpContext):
    """float32 [start, end) by step, as ``jnp.arange`` of the inputs' host
    values (numpy's arithmetic in float64, then rounded)."""
    vals = [float(_host_scalar(ctx.input(s))) for s in ("Start", "End",
                                                         "Step")]
    out = np.arange(*vals).astype(np.float32)
    ctx.set_output("Out", torch.from_numpy(out).to(ctx.device))


@register_op("linspace")
def linspace_op(ctx: OpContext):
    s, e = (float(_host_scalar(ctx.input(n))) for n in ("Start", "Stop"))
    n = int(_host_scalar(ctx.input("Num")))
    out = np.linspace(s, e, n).astype(np.float32)
    ctx.set_output("Out", torch.from_numpy(out).to(ctx.device))


# -- random ops ---------------------------------------------------------------


def _batch_size_like(ctx: OpContext, shape):
    """``shape`` with dim ``output_dim_idx`` taken from the ``Input``'s
    dim ``input_dim_idx`` (the ``*_batch_size_like`` ops)."""
    if ctx.has_input("Input"):
        shape[ctx.attr("output_dim_idx", 0)] = ctx.input("Input").shape[
            ctx.attr("input_dim_idx", 0)]
    return shape


@register_op("uniform_random", "uniform_random_batch_size_like")
def uniform_random_op(ctx: OpContext):
    shape = _batch_size_like(ctx, list(ctx.attr("shape")))
    dtype = to_torch_dtype(ctx.attr("dtype", "float32"))
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    u = torch.rand(shape, generator=ctx.rng(), dtype=torch.float32,
                   device=ctx.device)
    ctx.set_output("Out", (u * (hi - lo) + lo).to(dtype))


@register_op("gaussian_random", "gaussian_random_batch_size_like")
def gaussian_random_op(ctx: OpContext):
    shape = _batch_size_like(ctx, list(ctx.attr("shape")))
    dtype = to_torch_dtype(ctx.attr("dtype", "float32"))
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    z = torch.randn(shape, generator=ctx.rng(), dtype=torch.float32,
                    device=ctx.device)
    ctx.set_output("Out", (mean + std * z).to(dtype))


# erf(±2/√2): the normal CDF at ±2 standard deviations, mapped to [-1, 1]
_ERF_2 = math.erf(2.0 / math.sqrt(2.0))


@register_op("truncated_gaussian_random")
def truncated_gaussian_random_op(ctx: OpContext):
    """mean + std·z with z standard normal truncated to [-2, 2], as the JAX
    package draws it (``jax.random.truncated_normal(key, -2, 2)``), by the
    inverse CDF: u uniform in (erf(-√2), erf(√2)), z = √2·erfinv(u). The
    draw happens in place on the run's device from the op's generator, so
    a [5e7, 10] table never passes through the host or a second buffer."""
    shape = list(ctx.attr("shape"))
    dtype = to_torch_dtype(ctx.attr("dtype", "float32"))
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    z = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    z.uniform_(-_ERF_2, _ERF_2, generator=ctx.rng())
    z.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    ctx.set_output("Out", z.mul_(std).add_(mean).to(dtype))


@register_op("randint")
def randint_op(ctx: OpContext):
    """int32 uniform in [low, high) from the op's generator."""
    ctx.set_output("Out", torch.randint(
        ctx.attr("low", 0), ctx.attr("high"), list(ctx.attr("shape")),
        generator=ctx.rng(), dtype=torch.int32, device=ctx.device))


def keep_mask(shape, p, generator, device):
    """Bool mask, True with probability ``1 - p``: the residual dropout
    keeps for the backward is this 1-byte mask, not an x.dtype one."""
    return torch.rand(shape, generator=generator, device=device) >= p


@register_op("dropout")
def dropout_op(ctx: OpContext):
    """Reference: operators/dropout_op.cc. Two impl modes:
    downgrade_in_infer (default): train out = x*mask, infer out = x*(1-p);
    upscale_in_train: train out = x*mask/(1-p), infer out = x.
    """
    x = ctx.input("X")
    p = ctx.attr("dropout_prob", 0.5)
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.is_test:
        if impl == "upscale_in_train":
            ctx.set_output("Out", x)
        else:
            ctx.set_output("Out", x * (1.0 - p))
        return
    if p == 0.0:
        ctx.set_output("Out", x)
        if ctx.has_output("Mask"):
            ctx.set_output("Mask", torch.ones_like(x))
        return
    keep = keep_mask(x.shape, p, ctx.rng(), x.device)
    if impl == "upscale_in_train":
        out = torch.where(keep, x * (1.0 / (1.0 - p)), 0.0)
    else:
        out = torch.where(keep, x, 0.0)
    ctx.set_output("Out", out)
    if ctx.has_output("Mask"):
        ctx.set_output("Mask", keep.to(x.dtype))


# -- layout ops -------------------------------------------------------------


@register_op("shuffle_channel")
def shuffle_channel_op(ctx: OpContext):
    x = ctx.input("X")
    g = ctx.attr("group")
    n, c, h, w = x.shape
    ctx.set_output("Out", x.reshape(n, g, c // g, h, w).transpose(1, 2)
                   .reshape(n, c, h, w))


@register_op("label_smooth")
def label_smooth_op(ctx: OpContext):
    """(1 - ε)·X + ε·prior, the prior uniform (1/K) unless ``PriorDist``
    is given. The constants are rounded to X's dtype first, as the JAX
    package's weakly typed scalars are, so a bf16 label smooths to the
    same bits."""
    x = ctx.input("X")
    eps = ctx.attr("epsilon", 0.1)
    k = x.shape[-1]
    prior = ctx.input("PriorDist")
    if prior is None:
        prior = torch.full((k,), 1.0 / k, dtype=x.dtype, device=x.device)
    ctx.set_output("Out", _in_dtype(1.0 - eps, x.dtype) * x
                   + _in_dtype(eps, x.dtype) * prior)


def _in_dtype(c, dtype):
    """The Python float ``c`` rounded to ``dtype`` (on the host)."""
    return float(torch.tensor(c, dtype=dtype))


@register_op("pixel_shuffle")
def pixel_shuffle_op(ctx: OpContext):
    x = ctx.input("X")
    r = ctx.attr("upscale_factor")
    n, c, h, w = x.shape
    ctx.set_output("Out", x.reshape(n, c // (r * r), r, r, h, w)
                   .permute(0, 1, 4, 2, 5, 3)
                   .reshape(n, c // (r * r), h * r, w * r))


@register_op("space_to_depth")
def space_to_depth_op(ctx: OpContext):
    x = ctx.input("X")
    b = ctx.attr("blocksize")
    n, c, h, w = x.shape
    ctx.set_output("Out", x.reshape(n, c, h // b, b, w // b, b)
                   .permute(0, 3, 5, 1, 2, 4)
                   .reshape(n, c * b * b, h // b, w // b))


@register_op("load")
def load_op(ctx: OpContext):
    """Reference: operators/load_op.cc. The file (``.npy``, or the entry
    of a ``.npz`` named as the output var, as ``io.save_vars`` writes
    them) is read once per device and kept on the op, as the JAX package
    reads it once while tracing; ``load_as_fp16`` gives float16."""
    path = ctx.attr("file_path")
    fp16 = ctx.attr("load_as_fp16", False)

    def read():
        data = np.load(path, allow_pickle=False)
        if isinstance(data, np.lib.npyio.NpzFile):
            key = ctx.op.outputs["Out"][0]
            if key not in data:
                raise KeyError("load: %r has no entry %r (archive keys: %s)"
                               % (path, key, sorted(data.files)))
            data = data[key]
        out = torch.from_numpy(np.ascontiguousarray(data)).to(ctx.device)
        return out.half() if fp16 else out

    ctx.set_output("Out", _cached(ctx, (ctx.device, path, fp16), read))
