# ported from paddle_tpu/ops/metric_ops.py
"""Sequence and classification metric ops: ``chunk_eval``,
``edit_distance``, ``precision_recall`` and ``positive_negative_pair``
(reference: operators/chunk_eval_op.h, edit_distance_op.cc,
precision_recall_op.cc, positive_negative_pair_op.h).

The reference walks sequences with host loops. As in the JAX package,
chunk detection is a pair of positional begin/end predicates over the
padded batch (two chunks are the same iff they begin at the same place,
end at the same place and have the same type), so the counts are sums of
mask conjunctions. Edit distance is a dynamic-programming pass over the
anti-diagonals of the [Lh + 1, Lr + 1] table: ``Lh + Lr`` steps, each
computing one diagonal of every row at once (the JAX package scans row
by row and within each row). Nothing reads the host, so each op captures.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import OpContext, register_op

_SCHEMES = {
    # scheme: (number of tag types, begin, inside, end, single)
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _chunk_bounds(labels, lens, num_chunk_types, scheme):
    """labels [B, T] → (is_begin, end position of the chunk open at each
    position, type), by the reference's ChunkBegin/ChunkEnd predicates
    (chunk_eval_op.h:83,96) over the padded batch; padding is Outside."""
    ntag, t_begin, t_inside, t_end, t_single = _SCHEMES[scheme]
    other = num_chunk_types
    t = labels.shape[1]
    tag = labels % ntag
    typ = labels // ntag
    idx = torch.arange(t, device=labels.device)[None, :]
    typ = torch.where(idx < lens[:, None], typ, other)

    prev_tag = F.pad(tag, (1, 0))[:, :t]
    prev_typ = F.pad(typ, (1, 0), value=other)[:, :t]
    next_tag = F.pad(tag, (0, 1))[:, 1:]
    next_typ = F.pad(typ, (0, 1), value=other)[:, 1:]

    def either(x, a, b):
        return (x == a) | (x == b)

    # a chunk begins at i iff ChunkBegin(prev=i-1, cur=i)
    begin = torch.where(
        prev_typ == other, typ != other,
        torch.where(typ != prev_typ, True,
                    (tag == t_begin) | (tag == t_single)
                    | (((tag == t_inside) | (tag == t_end))
                       & either(prev_tag, t_end, t_single))))
    is_begin = begin & (typ != other)
    # a chunk ends at i iff ChunkEnd(prev=i, cur=i+1)
    is_end = (typ != other) & torch.where(
        (next_typ == other) | (next_typ != typ), True,
        (tag == t_end) | (tag == t_single)
        | (((tag == t_begin) | (tag == t_inside))
           & either(next_tag, t_begin, t_single)))
    # the end of the chunk open at or after i: a reversed running minimum
    end_idx = torch.where(is_end, idx, t + 1)
    end_pos = end_idx.flip(1).cummin(dim=1).values.flip(1)
    return is_begin, end_pos, typ


def _ratio(num, den):
    return torch.where(den > 0, num / den.clamp(min=1), 0.0).to(torch.float32)


@register_op("chunk_eval")
def chunk_eval_op(ctx: OpContext):
    """Inference [B, T] + Label [B, T] (+ Length [B]) → Precision, Recall,
    F1-Score [1] float32 and NumInferChunks, NumLabelChunks,
    NumCorrectChunks [1] int32, for the IOB, IOE, IOBES and plain
    schemes, chunks of the ``excluded_chunk_types`` left out."""
    inf, lab = ctx.input("Inference"), ctx.input("Label")
    if inf.dim() == 3:
        inf = inf[..., 0]
    if lab.dim() == 3:
        lab = lab[..., 0]
    inf, lab = inf.long(), lab.long()
    nct = int(ctx.attr("num_chunk_types"))
    scheme = ctx.attr("chunk_scheme", "IOB")
    excluded = list(ctx.attr("excluded_chunk_types", []) or [])
    b, t = inf.shape
    lens = ctx.input("Length")
    lens = torch.full((b,), t, dtype=torch.long, device=inf.device) \
        if lens is None else lens.reshape(-1).long()

    ib_i, ep_i, ty_i = _chunk_bounds(inf, lens, nct, scheme)
    ib_l, ep_l, ty_l = _chunk_bounds(lab, lens, nct, scheme)

    def counted(ty):
        ok = torch.ones_like(ty, dtype=torch.bool)
        for e in excluded:
            ok &= ty != e
        return ok

    n_inf = (ib_i & counted(ty_i)).sum().to(torch.int32)
    n_lab = (ib_l & counted(ty_l)).sum().to(torch.int32)
    n_cor = (ib_i & ib_l & (ty_i == ty_l) & (ep_i == ep_l)
             & counted(ty_i)).sum().to(torch.int32)
    p = _ratio(n_cor, n_inf)
    r = _ratio(n_cor, n_lab)
    f1 = torch.where(p + r > 0, 2 * p * r / torch.clamp(p + r, min=1e-12),
                     0.0)
    ctx.set_output("Precision", p.reshape(1))
    ctx.set_output("Recall", r.reshape(1))
    ctx.set_output("F1-Score", f1.reshape(1))
    ctx.set_output("NumInferChunks", n_inf.reshape(1))
    ctx.set_output("NumLabelChunks", n_lab.reshape(1))
    ctx.set_output("NumCorrectChunks", n_cor.reshape(1))


def levenshtein(hyps, refs, hl, rl):
    """Edit distances [B] (float32) of hyps [B, Lh] against refs [B, Lr],
    each row to its lengths ``hl``, ``rl`` [B]. Diagonal d of the table
    holds the cells (i, d - i), kept as a [B, Lh + 1] tensor indexed by
    i; each step makes diagonal d from d - 1 and d - 2 for every row at
    once, and a row's distance is read from diagonal hl + rl at i = hl."""
    b, lh = hyps.shape
    lr = refs.shape[1]
    dev = hyps.device
    i = torch.arange(lh + 1, device=dev)
    h_prev = F.pad(hyps, (1, 0), value=-1)        # h_prev[:, i] = hyps[i-1]
    big = float(lh + lr + 1)
    inf_row = torch.full((b, lh + 1), big, device=dev)
    prev2 = inf_row
    prev = torch.where(i == 0, 0.0, inf_row)       # diagonal 0
    target = (hl + rl)[:, None]
    dist = torch.where(target == 0, prev[:, :1], 0.0)
    at = hl[:, None]
    for d in range(1, lh + lr + 1):
        j = d - i
        inside = (j >= 0) & (j <= lr)
        r_at = torch.take_along_dim(
            refs, (j - 1).clamp(0, max(lr - 1, 0)).expand(b, -1), dim=1)
        sub = F.pad(prev2, (1, 0), value=big)[:, :lh + 1] \
            + (h_prev != r_at).to(torch.float32)
        up = F.pad(prev, (1, 0), value=big)[:, :lh + 1] + 1.0
        cur = torch.minimum(torch.minimum(sub, up), prev + 1.0)
        # the first row and column hold their index
        cur = torch.where(i == 0, float(d), torch.where(j == 0, float(d), cur))
        cur = torch.where(inside, cur, big)
        hit = torch.take_along_dim(cur, at, dim=1)
        dist = torch.where(target == d, hit, dist)
        prev2, prev = prev, cur
    return dist[:, 0]


@register_op("edit_distance")
def edit_distance_op(ctx: OpContext):
    """Levenshtein distance (reference: edit_distance_op.cc). Hyps
    [B, Lh] + HypsLength, Refs [B, Lr] + RefsLength → Out [B, 1] float32
    (divided by the reference's length when ``normalized``), SequenceNum
    [1] int32."""
    hyps, refs = ctx.input("Hyps").long(), ctx.input("Refs").long()
    b, lh = hyps.shape
    lr = refs.shape[1]
    hl, rl = ctx.input("HypsLength"), ctx.input("RefsLength")
    hl = torch.full((b,), lh, dtype=torch.long, device=hyps.device) \
        if hl is None else hl.reshape(-1).long()
    rl = torch.full((b,), lr, dtype=torch.long, device=hyps.device) \
        if rl is None else rl.reshape(-1).long()
    dist = levenshtein(hyps, refs, hl, rl)
    if ctx.attr("normalized", False):
        dist = dist / rl.to(torch.float32).clamp(min=1.0)
    ctx.set_output("Out", dist[:, None])
    ctx.set_output("SequenceNum", torch.full((1,), b, dtype=torch.int32,
                                             device=hyps.device))


def _pr_metrics(st):
    """[macro P, R, F1, micro P, R, F1] of per-class (TP, FP, TN, FN)."""
    tp, fp, fn = st[:, 0], st[:, 1], st[:, 3]

    def safe(num, den):
        return torch.where(den > 0, num / torch.clamp(den, min=1e-12), 0.0)

    prec, rec = safe(tp, tp + fp), safe(tp, tp + fn)
    f1 = safe(2 * prec * rec, prec + rec)
    stp, sfp, sfn = tp.sum(), fp.sum(), fn.sum()
    mp, mr = safe(stp, stp + sfp), safe(stp, stp + sfn)
    mf = safe(2 * mp * mr, mp + mr)
    return torch.stack([prec.mean(), rec.mean(), f1.mean(), mp, mr, mf])


@register_op("precision_recall")
def precision_recall_op(ctx: OpContext):
    """Multi-class precision, recall and F1 (reference:
    precision_recall_op.cc). Indices [B, 1] predicted class, Labels
    [B, 1], Weights [B, 1] optional, StatesInfo [C, 4] (TP, FP, TN, FN a
    class) optional → BatchMetrics [6] (macro P, R, F1, micro P, R, F1),
    AccumMetrics [6], AccumStatesInfo [C, 4]."""
    idx = ctx.input("Indices").reshape(-1).long()
    lab = ctx.input("Labels").reshape(-1).long()
    w, states = ctx.input("Weights"), ctx.input("StatesInfo")
    c = int(ctx.attr("class_number"))
    b = idx.shape[0]
    w = torch.ones(b, device=idx.device) if w is None \
        else w.reshape(-1).float()
    pred = F.one_hot(idx, c).float() * w[:, None]
    true = F.one_hot(lab, c).float() * w[:, None]
    tp = (pred * (idx == lab)[:, None].float()).sum(dim=0)
    fp = pred.sum(dim=0) - tp
    fn = true.sum(dim=0) - tp
    tn = w.sum() - tp - fp - fn
    batch = torch.stack([tp, fp, tn, fn], dim=1)
    accum = batch if states is None else states.float() + batch
    ctx.set_output("BatchMetrics", _pr_metrics(batch))
    ctx.set_output("AccumMetrics", _pr_metrics(accum))
    ctx.set_output("AccumStatesInfo", accum)


@register_op("positive_negative_pair")
def positive_negative_pair_op(ctx: OpContext):
    """Ranking pairs (reference: positive_negative_pair_op.h): over every
    pair of a query's documents with different labels, positive when the
    scores order them as the labels do, negative when they disagree,
    neutral on a tied score (as the reference's Python oracle counts; its
    C++ kernel also counts a tie as negative), each pair weighted by the
    mean of its documents' weights. One dense [N, N] mask reduction, as
    in the JAX package."""
    score = ctx.input("Score")
    label = ctx.input("Label").reshape(-1).float()
    query = ctx.input("QueryID").reshape(-1)
    weight = ctx.input("Weight")
    s = score[:, int(ctx.attr("column", -1))].float()
    n = s.shape[0]
    w = torch.ones(n, device=s.device) if weight is None \
        else weight.reshape(-1).float()
    upper = torch.ones((n, n), dtype=torch.bool, device=s.device).triu(1)
    valid = upper & (query[:, None] == query[None, :]) \
        & (label[:, None] != label[None, :])
    pair_w = torch.where(valid, (w[:, None] + w[None, :]) * 0.5, 0.0)
    prod = (s[:, None] - s[None, :]) * (label[:, None] - label[None, :])
    tie = s[:, None] == s[None, :]
    pos = torch.where(~tie & (prod > 0), pair_w, 0.0).sum()
    neg = torch.where(~tie & (prod <= 0), pair_w, 0.0).sum()
    neu = torch.where(tie, pair_w, 0.0).sum()
    for name, base in (("PositivePair", pos), ("NegativePair", neg),
                       ("NeutralPair", neu)):
        acc = ctx.input("Accumulate" + name)
        if acc is not None:
            base = base + acc.reshape(()).float()
        ctx.set_output(name, base.reshape(1))
