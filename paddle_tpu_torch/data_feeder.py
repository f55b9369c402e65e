# ported from paddle_tpu/data_feeder.py
"""DataFeeder (reference: python/paddle/fluid/data_feeder.py:100).

Converts reader minibatches (lists of per-example tuples) into the feed dict
the Executor consumes. LoD-style nested sequences are padded to the batch max
length with an accompanying ``<name>_mask`` array when requested — the
segment-ids/packing replacement for LoDTensor (SURVEY §5.7).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .core.dtypes import convert_dtype
from .core.framework import Variable
from .core.place import CUDAPinnedPlace

__all__ = ["DataFeeder"]


class DataFeeder:
    def __init__(self, feed_list: Sequence[Variable], place=None, program=None,
                 pad_sequences: bool = False, emit_masks: bool = False):
        self.feed_vars = list(feed_list)
        self.place = place
        self.pad_sequences = pad_sequences
        self.emit_masks = emit_masks

    def feed(self, iterable) -> Dict[str, np.ndarray]:
        """iterable: list of examples, each a tuple/list with one entry per
        feed var. Returns {var_name: batched ndarray}, or pinned host
        tensors when the feeder's place is a ``CUDAPinnedPlace``."""
        rows = list(iterable)
        if not rows:
            raise ValueError("DataFeeder.feed got an empty minibatch")
        out: Dict[str, np.ndarray] = {}
        for i, var in enumerate(self.feed_vars):
            col = [r[i] for r in rows]
            dtype = np.dtype(convert_dtype(var.dtype)) if convert_dtype(var.dtype) != "bfloat16" else np.float32
            first = np.asarray(col[0])
            ragged = any(np.asarray(c).shape != first.shape for c in col)
            if ragged:
                if not self.pad_sequences:
                    raise ValueError(
                        "feed var %r has ragged examples; construct DataFeeder "
                        "with pad_sequences=True to pad to batch max length"
                        % var.name)
                maxlen = max(np.asarray(c).shape[0] for c in col)
                tail = np.asarray(col[0]).shape[1:]
                batch = np.zeros((len(col), maxlen) + tail, dtype=dtype)
                mask = np.zeros((len(col), maxlen), dtype=np.float32)
                for j, c in enumerate(col):
                    c = np.asarray(c, dtype=dtype)
                    batch[j, : c.shape[0]] = c
                    mask[j, : c.shape[0]] = 1.0
                out[var.name] = batch
                if self.emit_masks:
                    out[var.name + "_mask"] = mask
            else:
                arr = np.asarray(col, dtype=dtype)
                # Fluid convention: int64 label columns become [N, 1]
                shape = var.shape or ()
                if len(shape) > arr.ndim and shape[-1] == 1:
                    arr = arr.reshape(arr.shape + (1,))
                out[var.name] = arr
        if isinstance(self.place, CUDAPinnedPlace):
            # page-locked host tensors, which the card copies directly
            return {n: torch.from_numpy(a).pin_memory() for n, a in out.items()}
        return out
