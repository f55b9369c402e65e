# ported from paddle_tpu/ops/loss_ops.py
"""The linear-chain CRF: ``linear_chain_crf`` (the cost by the forward
algorithm and the gold path's score) and ``crf_decoding`` (Viterbi and
its backtrace), over padded emissions [B, T, D] and a ``Length`` [B].

The transition parameter is [D+2, D]: row 0 the start weights, row 1
the stop weights, then the D x D transitions (reference:
``linear_chain_crf_op.h``). Each recursion is a Python loop over the
static padded T (the JAX package's ``lax.scan``); a row past its length
keeps its state, so a row of length 0 scores as one of length 1, as in
the JAX package. The rest of the JAX package's ``loss_ops.py`` (``nce``,
``hierarchical_sigmoid``, ``warpctc``, ``ctc_align``, ``sample_logits``)
is not ported yet.
"""

from __future__ import annotations

import torch

from ..core.registry import OpContext, register_op


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
