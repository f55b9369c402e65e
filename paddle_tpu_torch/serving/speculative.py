# ported from paddle_tpu/serving/speculative.py
"""Speculative decoding: zero-weight drafters + the accept/reject math.

A host-side :class:`Drafter` proposes up to ``k`` continuation tokens per
scheduler tick, the target model verifies the whole window in ONE dispatch
(the engine's verify body → ``models.decoder_lm.verify_forward`` →
``kv_cache.*.decode_verify``, on the card the paged-attention kernel K3
over B*W pseudo-slots, inside a CUDA graph), and acceptance rolls
``ctx_len`` forward only over the verified prefix.

Correctness contract (the engine's hard invariant):

* The verify body samples the TARGET's own token at every window position
  with the (seed, absolute-position)-keyed RNG (``engine._sample_tokens``)
  and accepts draft token ``d_j`` iff it equals that target draw ``t_j``.
  For a DETERMINISTIC drafter (q is a point mass at ``d_j``) this IS exact
  speculative sampling: the accept probability is ``P(t_j = d_j) = p(d_j)
  = min(1, p(d_j)/q(d_j))``, and on rejection the emitted token ``t_j |
  t_j != d_j`` is distributed as the normalized residual ``max(0, p -
  q)`` — the Leviathan et al. accept/reject rule, specialized to q =
  delta. Because every draw is a pure function of (seed, position), the
  emitted stream is BIT-identical to plain decode — greedy by the argmax
  path, sampled by RNG keying.
* :func:`residual_sample` is the GENERAL accept/reject step (host-side
  reference) a model-based drafter with a non-degenerate proposal
  distribution would plug into.

The shipped drafter is :class:`NGramDrafter` — prompt-lookup decoding:
match the trailing n-gram of (prompt + generated) against its own history
and propose the continuation that followed last time. Zero weights, zero
device work.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["Drafter", "NGramDrafter", "make_drafter", "residual_sample",
           "SPEC_K_CAP", "parse_speculation", "verify_window_args"]

# Bound on per-request draft k: the verify window width is k+1, and each
# distinct width is one CUDA graph — the cap keeps a hostile per-request
# knob from capturing unbounded graphs.
SPEC_K_CAP = 8


class Drafter:
    """Proposes up to ``k`` continuation tokens for one request.

    ``propose`` sees the request's full token history (prompt + generated,
    host-side ints) and returns 0..k proposed next tokens.  A drafter is
    DETERMINISTIC by contract (``kind`` names it in provenance): the
    engine's equality-accept verify implements exact speculative sampling
    only for point-mass proposals — a future stochastic/model drafter must
    also return its per-token proposal probabilities and route through
    :func:`residual_sample` instead.
    """

    kind = "base"

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Prompt-lookup decoding: the zero-weight n-gram drafter.

    Finds the most recent PRIOR occurrence of the trailing ``n``-gram of
    ``history`` (longest ``n`` first, ``max_n`` down to ``min_n``) and
    proposes the tokens that followed it, capped at ``k``.  No match →
    empty draft → the slot degrades to a plain one-token step inside the
    same verify dispatch.
    """

    kind = "ngram"

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not (1 <= min_n <= max_n):
            raise ValueError("need 1 <= min_n <= max_n, got min_n=%d "
                             "max_n=%d" % (min_n, max_n))
        self.max_n = int(max_n)
        self.min_n = int(min_n)

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        h = list(history)
        n_hist = len(h)
        if k <= 0 or n_hist < self.min_n + 1:
            return []
        for n in range(min(self.max_n, n_hist - 1), self.min_n - 1, -1):
            suffix = h[-n:]
            # rightmost prior occurrence: recent context predicts best
            for start in range(n_hist - n - 1, -1, -1):
                if h[start:start + n] == suffix:
                    cont = h[start + n:start + n + k]
                    if cont:
                        return [int(t) for t in cont]
        return []


def make_drafter(kind: str, **kw) -> Drafter:
    """Drafter factory keyed by ``ServingConfig.spec_drafter`` — "ngram"
    today; a small-model drafter registers here when it lands."""
    if kind == "ngram":
        return NGramDrafter(**kw)
    raise ValueError("unknown drafter kind %r (have: 'ngram')" % (kind,))


def parse_speculation(value) -> Optional[object]:
    """Normalize a speculation knob (config, env var, or wire field) to
    ``0`` (off), a positive int draft-k (capped at :data:`SPEC_K_CAP`), or
    the string ``"auto"`` (the engine resolves it to its default k).
    ``None`` stays ``None`` (= inherit the engine default)."""
    if value is None:
        return None
    if isinstance(value, str):
        v = value.strip().lower()
        if v in ("", "0", "off", "none", "false", "no"):
            return 0
        if v == "auto":
            return "auto"
        value = int(v)
    k = int(value)
    if k < 0:
        raise ValueError("speculation must be >= 0, 'auto' or None, got %r"
                         % (value,))
    return min(k, SPEC_K_CAP)


def verify_window_args(window: int, proposed: int, accepted: int) -> dict:
    """Span-arg payload tagging a verify dispatch: the window width (k+1
    model positions), how many draft tokens rode it and how many the
    target accepted — the JAX package's schema, for its phase ledger."""
    return {"verify": True, "window": int(window),
            "proposed": int(proposed), "accepted": int(accepted)}


def residual_sample(p: np.ndarray, q: np.ndarray, draft_token: int,
                    u_accept: float, u_residual: float) -> tuple:
    """One general accept/reject speculative-sampling step (host reference).

    ``p`` is the target distribution, ``q`` the drafter's proposal
    distribution over the same vocab, ``draft_token`` the drafter's draw,
    ``u_accept``/``u_residual`` uniform [0,1) variates.  Accept with
    probability ``min(1, p[d]/q[d])``; on rejection draw from the
    normalized residual ``max(0, p - q)``.  Returns ``(token, accepted)``.
    Marginally the emitted token is distributed EXACTLY as ``p`` (the
    Leviathan et al. guarantee).  The engine's verify body never calls
    this: its drafters are deterministic, where equality-accept against
    the position-keyed target draw is this same rule with q = delta.
    """
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    d = int(draft_token)
    qd = q[d]
    accept = qd > 0.0 and u_accept < min(1.0, p[d] / qd)
    if accept:
        return d, True
    resid = np.maximum(p - q, 0.0)
    z = resid.sum()
    if z <= 0.0:
        # p <= q everywhere except where they agree: p == q, accept was
        # certain — numerically degenerate; fall back to the target draw
        resid, z = p, p.sum()
    resid = resid / z
    token = int(np.searchsorted(np.cumsum(resid), u_residual, side="right"))
    return min(token, len(p) - 1), False
