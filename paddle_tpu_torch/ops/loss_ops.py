# ported from paddle_tpu/ops/loss_ops.py
"""Structured losses over padded batches: the linear-chain CRF
(``linear_chain_crf``, ``crf_decoding``), CTC (``warpctc``, ``ctc_align``)
and the sampled classification heads (``nce``, ``hierarchical_sigmoid``,
``sample_logits``). reference: ``warpctc_op.cc``, ``ctc_align_op.cc``,
``linear_chain_crf_op.cc``, ``crf_decoding_op.cc``, ``nce_op.cc``,
``hierarchical_sigmoid_op.cc`` + ``math/matrix_bit_code.h``,
``sample_logits_op.cc``.

The CRF's transition parameter is [D+2, D]: row 0 the start weights, row 1
the stop weights, then the D x D transitions (reference:
``linear_chain_crf_op.h``). Each recursion (the CRF's forward algorithm
and Viterbi, CTC's alpha) is a Python loop over the static padded T (the
JAX package's ``lax.scan``); a row past its length keeps its state, so a
row of length 0 scores as one of length 1, as in the JAX package.

Nothing here reads the host, so every op captures. Where an op gathers
rows that repeat (CTC's extended label, the heads' sampled classes), the
gather is one whose gradient sums the repeats in the same order on every
run: a one-hot product for CTC's emissions, ``nn_ops._Lookup`` for the
heads' weight and logit rows. The sampling ops draw from the op's
generator (``ctx.rng()``), so a captured step replays them as it replays
dropout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import OpContext, register_op
from .nn_ops import _Lookup

# the log-space stand-in for -inf of the CTC recursion (the JAX package's)
_NEG = -1e30


def _crf_inputs(ctx):
    emission = ctx.input("Emission").float()
    transition = ctx.input("Transition").float()
    b, t, _ = emission.shape
    length = ctx.input("Length")
    if length is None:
        length = torch.full((b,), t, dtype=torch.int64,
                            device=emission.device)
    length = length.reshape(-1).to(torch.int64)
    return emission, transition, length


def _labels(label):
    label = label.to(torch.int64)
    return label[..., 0] if label.dim() == 3 else label


@register_op("linear_chain_crf")
def linear_chain_crf_op(ctx: OpContext):
    """Emission [B, T, D] + Length [B], Transition [D+2, D], Label [B, T]
    → LogLikelihood [B, 1], which is a cost: -(gold path score - log Z),
    as the reference's ``ForwardOneSequence`` returns it. reference:
    linear_chain_crf_op.cc."""
    emission, transition, length = _crf_inputs(ctx)
    label = _labels(ctx.input("Label"))
    b, t, _ = emission.shape
    start, stop, trans = transition[0], transition[1], transition[2:]

    # log Z by the forward recursion (unbind: one stack as its gradient)
    steps = emission.unbind(1)
    alpha = start[None, :] + steps[0]
    for s in range(1, t):
        new = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + steps[s]
        alpha = torch.where((s < length)[:, None], new, alpha)
    logz = torch.logsumexp(alpha + stop[None, :], dim=1)

    # the gold path: its labels are read while s < length, so the last
    # one scored is label[clamp(length - 1, 0, T - 1)]
    em_gold = torch.take_along_dim(emission, label[..., None], dim=2)[..., 0]
    score = start[label[:, 0]] + em_gold[:, 0]
    if t > 1:
        steps = trans[label[:, :-1], label[:, 1:]] + em_gold[:, 1:]
        active = torch.arange(1, t, device=emission.device)[None, :] \
            < length[:, None]
        score = score + torch.where(active, steps,
                                    torch.zeros_like(steps)).sum(dim=1)
    last = torch.take_along_dim(
        label, torch.clamp(length - 1, 0, t - 1)[:, None], dim=1)[:, 0]
    score = score + stop[last]

    ctx.set_output("LogLikelihood", (-(score - logz))[:, None])
    # the reference's auxiliary outputs (nothing reads them under autograd)
    ctx.set_output("Alpha", alpha)
    ctx.set_output("EmissionExps", torch.exp(emission))
    ctx.set_output("TransitionExps", torch.exp(transition))


@register_op("crf_decoding")
def crf_decoding_op(ctx: OpContext):
    """Viterbi decode (reference: crf_decoding_op.cc): Emission [B, T, D]
    + Length, Transition → ViterbiPath [B, T] int32, 0 at the padding;
    ties go to the first index (``torch.argmax``, as ``jnp.argmax``).
    With Label wired, the path's mismatch mask instead (1 where the path
    differs from the label within the length)."""
    emission, transition, length = _crf_inputs(ctx)
    b, t, d = emission.shape
    start, stop, trans = transition[0], transition[1], transition[2:]
    stay = torch.arange(d, device=emission.device)[None].expand(b, d)

    delta = start[None] + emission[:, 0]
    args = []
    for s in range(1, t):
        cand = delta[:, :, None] + trans[None]          # [B, D, D]
        best = torch.amax(cand, dim=1) + emission[:, s]
        arg = torch.argmax(cand, dim=1)
        active = (s < length)[:, None]
        delta = torch.where(active, best, delta)
        args.append(torch.where(active, arg, stay))
    cur = torch.argmax(delta + stop[None], dim=1)
    path = [cur]
    for arg in reversed(args):
        cur = torch.take_along_dim(arg, cur[:, None], dim=1)[:, 0]
        path.append(cur)
    path = torch.stack(path[::-1], dim=1)
    mask = torch.arange(t, device=emission.device)[None] < length[:, None]
    zero = torch.zeros((), dtype=torch.int32, device=emission.device)
    label = ctx.input("Label")
    if label is not None:
        path = (path != _labels(label)).to(torch.int32)
    ctx.set_output("ViterbiPath", torch.where(mask, path.to(torch.int32),
                                              zero))


# -- CTC ----------------------------------------------------------------------


def ctc_loss_padded(log_probs, labels, logit_lens, label_lens, blank=0):
    """CTC negative log-likelihood by the alpha recursion in log space:
    log_probs [B, T, C] (log-softmaxed), labels [B, L], logit_lens [B],
    label_lens [B] → loss [B] (reference: warpctc_op.cc, the warp-ctc
    library's forward pass). The extended label (blank, l1, blank, ...,
    blank) reads its emissions as a product with its one-hot [B, C, S],
    so their gradient sums repeated labels (every blank) in the same order
    on every run; each row's alpha is taken at its last frame as the loop
    passes it. Autograd differentiates the recursion."""
    b, t, c = log_probs.shape
    s = 2 * labels.shape[1] + 1
    dev = log_probs.device
    labels = labels.long()
    logit_lens, label_lens = logit_lens.long(), label_lens.long()
    ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    # a path may skip from s-2 to s where ext[s] is no blank and differs
    # from ext[s-2]
    ext_prev2 = F.pad(ext, (2, 0), value=-1)[:, :s]
    can_skip = (ext != blank) & (ext != ext_prev2)
    valid_s = torch.arange(s, device=dev)[None, :] < (2 * label_lens[:, None]
                                                      + 1)
    onehot = F.one_hot(ext.clamp(0, c - 1), c).to(log_probs.dtype)
    emit = torch.bmm(log_probs, onehot.transpose(1, 2))      # [B, T, S]
    neg = torch.full((), _NEG, dtype=log_probs.dtype, device=dev)
    has_label = label_lens > 0

    steps = emit.unbind(1)
    alpha = torch.cat([steps[0][:, :1],
                       torch.where(has_label[:, None], steps[0][:, 1:2], neg),
                       neg.expand(b, s - 2)], dim=1)
    last_t = (logit_lens - 1).clamp(0, t - 1)[:, None]
    last = alpha
    for i in range(1, t):
        a1 = F.pad(alpha, (1, 0), value=_NEG)[:, :s]
        a2 = torch.where(can_skip, F.pad(alpha, (2, 0), value=_NEG)[:, :s],
                         neg)
        m = torch.maximum(torch.maximum(alpha, a1), a2)
        summed = torch.exp(alpha - m) + torch.exp(a1 - m) + torch.exp(a2 - m)
        alpha = torch.where(valid_s, m + torch.log(summed) + steps[i], neg)
        last = torch.where(last_t == i, alpha, last)

    p_end = torch.take_along_dim(last, (2 * label_lens)[:, None], dim=1)[:, 0]
    p_end1 = torch.take_along_dim(
        last, (2 * label_lens - 1).clamp(min=0)[:, None], dim=1)[:, 0]
    p_end1 = torch.where(has_label, p_end1, neg)
    m = torch.maximum(p_end, p_end1)
    return -(m + torch.log(torch.exp(p_end - m) + torch.exp(p_end1 - m)))


def _lengths(t, n, b, dev):
    return torch.full((b,), n, dtype=torch.long, device=dev) if t is None \
        else t.reshape(-1).long()


@register_op("warpctc")
def warpctc_op(ctx: OpContext):
    """Logits [B, T, C] raw (softmax applied here, as warp-ctc does) +
    LogitsLength [B], Label [B, L] + LabelLength [B] → Loss [B, 1].
    ``norm_by_times`` divides each row's loss by its frame count, as the
    JAX package does."""
    logits, label = ctx.input("Logits"), ctx.input("Label")
    b, t, _ = logits.shape
    if label.dim() == 3:
        label = label[..., 0]
    lg_len = _lengths(ctx.input("LogitsLength"), t, b, logits.device)
    lb_len = _lengths(ctx.input("LabelLength"), label.shape[1], b,
                      logits.device)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    loss = ctc_loss_padded(log_probs, label, lg_len, lb_len,
                           int(ctx.attr("blank", 0)))
    if ctx.attr("norm_by_times", False):
        loss = loss / lg_len.to(loss.dtype).clamp(min=1.0)
    ctx.set_output("Loss", loss[:, None].to(logits.dtype))


@register_op("ctc_align")
def ctc_align_op(ctx: OpContext):
    """Greedy CTC collapse (reference: ctc_align_op.cc): repeats merged,
    blanks dropped. Input [B, T] int + Length [B] → Output [B, T] int32
    padded with -1, OutputLength [B] int32. Each kept id goes to its
    position among the kept (a cumulative sum) by one scatter; the
    dropped ones to a spare column past T."""
    ids = ctx.input("Input")
    if ids.dim() == 3:
        ids = ids[..., 0]
    ids = ids.long()
    b, t = ids.shape
    blank = int(ctx.attr("blank", 0))
    lens = _lengths(ctx.input("Length"), t, b, ids.device)
    pos = torch.arange(t, device=ids.device)[None, :]
    prev = F.pad(ids, (1, 0), value=-1)[:, :t]
    keep = (ids != blank) & (ids != prev) & (pos < lens[:, None])
    slot = torch.where(keep, torch.cumsum(keep, dim=1) - 1, t)
    out = ids.new_zeros((b, t + 1)).scatter(1, slot, ids)[:, :t]
    n = keep.sum(dim=1)
    out = torch.where(pos < n[:, None], out, -1)
    ctx.set_output("Output", out.to(torch.int32))
    ctx.set_output("OutputLength", n.to(torch.int32))


# -- the sampled heads --------------------------------------------------------


def _bce_with_logits(logit, target):
    """The JAX package's stable binary cross-entropy on logits."""
    return (torch.clamp(logit, min=0) - logit * target
            + torch.log1p(torch.exp(-torch.abs(logit))))


def _rows(w, ids):
    """``w[ids]`` for a [N, D] or [N] ``w``, with a gradient that sums
    repeated ids in the same order on every run."""
    if w.dim() == 1:
        return _Lookup.apply(w.reshape(-1, 1), ids)[..., 0]
    return _Lookup.apply(w, ids)


@register_op("nce")
def nce_op(ctx: OpContext):
    """Noise-contrastive estimation with the uniform sampler (reference:
    nce_op.cc). Input [B, D], Weight [C, D], Bias [C], Label [B, NT] →
    Cost [B, 1], SampleLogits [B, NT+K], SampleLabels [B, NT+K] int32. K
    negatives a row drawn uniformly from [0, C) by the op's generator;
    class 0s under ``is_test``, as in the JAX package."""
    x, w, bias = ctx.input("Input"), ctx.input("Weight"), ctx.input("Bias")
    label = ctx.input("Label").long()
    k = int(ctx.attr("num_neg_samples", 10))
    c = int(ctx.attr("num_total_classes", w.shape[0]))
    b, nt = label.shape
    if ctx.is_test:
        neg = torch.zeros((b, k), dtype=torch.long, device=x.device)
    else:
        neg = torch.randint(0, c, (b, k), generator=ctx.rng(),
                            device=x.device)
    samples = torch.cat([label, neg], dim=1)                  # [B, NT+K]
    logits = torch.einsum("bd,bsd->bs", x, _rows(w, samples))
    if bias is not None:
        logits = logits + _rows(bias.reshape(-1), samples)
    corrected = logits - math.log(k * (1.0 / c))
    target = torch.cat([torch.ones((b, nt), device=x.device),
                        torch.zeros((b, k), device=x.device)], dim=1)
    cost = _bce_with_logits(corrected, target).sum(dim=1, keepdim=True)
    ctx.set_output("Cost", cost)
    ctx.set_output("SampleLogits", logits)
    ctx.set_output("SampleLabels", samples.to(torch.int32))


@register_op("hierarchical_sigmoid")
def hierarchical_sigmoid_op(ctx: OpContext):
    """reference: hierarchical_sigmoid_op.cc + math/matrix_bit_code.h,
    SimpleCode: class c is the code c + C; bit i's node is row
    (code >> (i+1)) - 1 of W [C-1, D] and its target bit i of the code.
    Out [B, 1] = the sum of the path's binary cross-entropies, PreOut
    [B, ceil(log2 C) + 1] the path's logits (0 past its length). Unrolled
    over the ``ceil(log2 C) + 1`` bits with a mask a row; the path's
    length is the code's bit length less one, in integers."""
    x, w, bias = ctx.input("X"), ctx.input("W"), ctx.input("Bias")
    label = ctx.input("Label").long()
    c = int(ctx.attr("num_classes"))
    if label.dim() == 2:
        label = label[:, 0]
    code = label + c
    max_len = int(math.ceil(math.log2(max(c, 2)))) + 1
    length = sum((code >> (i + 1) > 0).long() for i in range(max_len))
    loss = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    pre_out = []
    for bit in range(max_len):
        node = ((code >> (bit + 1)) - 1).clamp(0, w.shape[0] - 1)
        target = ((code >> bit) & 1).to(torch.float32)
        logit = (x * _rows(w, node)).sum(dim=-1)
        if bias is not None:
            logit = logit + _rows(bias.reshape(-1), node)
        valid = bit < length
        loss = loss + torch.where(valid, _bce_with_logits(logit, target), 0.0)
        pre_out.append(torch.where(valid, logit, 0.0))
    ctx.set_output("Out", loss[:, None].to(x.dtype))
    ctx.set_output("PreOut", torch.stack(pre_out, dim=1))


@register_op("sample_logits")
def sample_logits_op(ctx: OpContext):
    """Sampled-softmax helper (reference: sample_logits_op.cc). Logits
    [B, C], Labels [B, NT] → Samples [B, NT+S] int32 (the labels, then S
    log-uniform negatives from the op's generator, or the
    ``CustomizedSamples``), Probabilities, SampledLogits [B, NT+S] (the
    logits at the samples, a negative equal to a true label pushed down by
    1e20, less the log of its probability), SampledLabels [B, NT]
    (0..NT-1)."""
    logits = ctx.input("Logits")
    labels = ctx.input("Labels").long()
    b, c = logits.shape
    nt = labels.shape[1]
    if ctx.input("CustomizedSamples") is not None:
        samples = ctx.input("CustomizedSamples").long()
        probs = ctx.input("CustomizedProbabilities")
    else:
        s = int(ctx.attr("num_samples", 10))
        u = torch.rand((b, s), generator=ctx.rng(), device=logits.device)
        # log-uniform (Zipfian) by the inverse CDF
        neg = (torch.exp(u * math.log(c + 1.0)) - 1.0).to(torch.int32)
        samples = torch.cat([labels, neg.long().clamp(0, c - 1)], dim=1)
        f = samples.to(torch.float32)
        probs = torch.log((f + 2.0) / (f + 1.0)) / math.log(c + 1.0)
    rows = samples + torch.arange(b, device=logits.device)[:, None] * c
    sampled = _rows(logits.reshape(-1), rows)
    if ctx.attr("remove_accidental_hits", True) and nt:
        hit = (samples[:, nt:, None] == samples[:, None, :nt]).any(dim=-1)
        mask = torch.cat([hit.new_zeros((b, nt)), hit], dim=1)
        sampled = torch.where(mask, sampled - 1e20, sampled)
    sampled = sampled - torch.log(torch.clamp(probs, min=1e-20))
    ctx.set_output("Samples", samples.to(torch.int32))
    ctx.set_output("Probabilities", probs)
    ctx.set_output("SampledLogits", sampled)
    ctx.set_output("SampledLabels", torch.arange(
        nt, dtype=torch.int32, device=logits.device).expand(b, nt))
