# ported from paddle_tpu/contrib/slim/prune/pruner.py
"""Pruners (reference: contrib/slim/prune/pruner.py — Pruner /
MagnitudePruner / RatioPruner).

The reference builds little mask programs (less_than/topk) and runs them to
zero weights. Here, as in the JAX package, pruners compute masks with
numpy on a host copy of the value (``PruneStrategy`` makes it) — same
masks, no auxiliary program execution.
``prune`` returns the zero/one mask for a parameter value.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Pruner", "MagnitudePruner", "RatioPruner"]


class Pruner:
    def prune(self, value, **kw):
        raise NotImplementedError


class MagnitudePruner(Pruner):
    """Zero weights with |w| below a fixed threshold."""

    def __init__(self, threshold):
        self.threshold = threshold

    def prune(self, value, threshold=None):
        t = self.threshold if threshold is None else threshold
        v = np.asarray(value)
        return (np.abs(v) >= t).astype(v.dtype)


class RatioPruner(Pruner):
    """Keep the largest-|w| ``ratio`` fraction per parameter.

    ``ratios`` maps param name -> keep-ratio ('*' is the default), matching
    the reference's `ratio=40%` == "prune the other 60%" convention.
    """

    def __init__(self, ratios=None):
        self.ratios = ratios or {"*": 1.0}

    def ratio_for(self, name):
        return self.ratios.get(name, self.ratios.get("*", 1.0))

    def prune(self, value, ratio=None, name=None):
        v = np.asarray(value)
        r = ratio if ratio is not None else self.ratio_for(name)
        if r >= 1.0:
            return np.ones_like(v)
        k = max(int(r * v.size), 1)
        flat = np.abs(v).reshape(-1)
        thresh = np.partition(flat, -k)[-k]
        return (np.abs(v) >= thresh).astype(v.dtype)
