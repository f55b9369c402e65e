# ported from paddle_tpu/data/multislot.py
"""MultiSlot streaming text readers — AsyncExecutor parity, checkpointable.

The reference framework's production CTR ingestion is AsyncExecutor +
MultiSlotDataFeed (SURVEY L4): text lines of ``<count> <values...>`` per
slot, parsed by trainer threads into padded batches. This module feeds the
SAME on-disk format through :class:`~.reader.CheckpointableReader`, so the
streaming path gains what AsyncExecutor never had: an exactly-once
checkpointable position, typed corrupt-record quarantine, and a bounded
prefetch that composes with ``DevicePrefetcher``.

Two readers:

* :class:`MultiSlotTextReader` — generic slots (``DataFeedDesc`` objects
  or :func:`slot` specs), batching to the framework's padded+``_length``
  convention for sparse slots (byte-identical feeds to
  ``AsyncExecutor.run`` over the same files — tested).
* :class:`CTRMultiSlotReader` — the DeepFM/CTR shape: ``label`` slot +
  one dense slot + ``num_fields`` single-id sparse slots per line,
  yielding ``{"ids": [B, F] int64, "dense": [B, D] float32,
  "label": [B, 1] int64}`` — exactly ``bench.py``'s DeepFM feed, schema
  validated per record (a field slot with 0 or 2 ids is a corrupt record,
  not a crash).

:func:`write_ctr_shards` generates synthetic shards in this format for
benches and drills.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..async_executor import _parse_multislot_line
from .reader import CheckpointableReader, FieldSpec

__all__ = [
    "slot", "MultiSlotTextReader", "CTRMultiSlotReader",
    "ctr_slots", "write_ctr_shards",
]


class _Slot:
    __slots__ = ("name", "type", "is_dense", "is_used", "dense_dim")

    def __init__(self, name, type="uint64", is_dense=False, is_used=True,
                 dense_dim=1):
        self.name = name
        self.type = type
        self.is_dense = is_dense
        self.is_used = is_used
        self.dense_dim = dense_dim


def slot(name: str, type: str = "uint64", is_dense: bool = False,
         is_used: bool = True, dense_dim: int = 1) -> _Slot:
    """A slot spec compatible with ``DataFeedDesc`` slots (same attrs)."""
    return _Slot(name, type, is_dense, is_used, dense_dim)


def _multislot_parse_fn(slots):
    """parse_fn: one MultiSlot line -> {slot name: per-record array} via
    the SAME parser AsyncExecutor uses (byte-format parity by
    construction). Dense slots additionally validate their declared dim."""

    def parse(line: str) -> Dict[str, np.ndarray]:
        vals = _parse_multislot_line(line, slots)
        rec = {}
        for s, v in zip(slots, vals):
            if not s.is_used:
                continue
            if s.is_dense and len(v) != s.dense_dim:
                raise ValueError("dense slot %r has %d values, declared %d"
                                 % (s.name, len(v), s.dense_dim))
            rec[s.name] = (v.astype(np.float32)
                           if s.type.startswith("float") else v)
        return rec

    return parse


def _multislot_collate(slots):
    """AsyncExecutor's batch convention: dense -> [B, dim]; sparse
    (variable length) -> ``<name>`` [B, Lmax] padded with 0 +
    ``<name>_length`` [B] int64."""
    used = [s for s in slots if s.is_used]

    def collate(records: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        feed = {}
        for s in used:
            col = [r[s.name] for r in records]
            if s.is_dense:
                feed[s.name] = np.stack(col).astype(
                    np.float32 if s.type.startswith("float") else np.int64)
            else:
                lens = np.asarray([len(c) for c in col], np.int64)
                lmax = max(1, int(lens.max()))
                padded = np.zeros((len(col), lmax), col[0].dtype)
                for r, c in enumerate(col):
                    padded[r, :len(c)] = c
                feed[s.name] = padded
                feed[s.name + "_length"] = lens
        return feed

    return collate


class MultiSlotTextReader(CheckpointableReader):
    """Checkpointable MultiSlot reader over sharded text files.

    ``slots`` accepts :func:`slot` specs or a ``DataFeedDesc``'s slots
    (same attribute shape). Feeds are batch-identical to
    ``AsyncExecutor.run`` over the same files, plus the exactly-once /
    quarantine machinery of :class:`CheckpointableReader`."""

    def __init__(self, shards: Sequence[str], slots, batch_size: int, **kw):
        slots = list(slots)
        super().__init__(
            shards, _multislot_parse_fn(slots), batch_size,
            collate_fn=_multislot_collate(slots), **kw)
        self.slots = slots


def ctr_slots(num_fields: int = 26, dense_dim: int = 13):
    """The dist_ctr line layout: label, dense, then one sparse slot per
    hashed feature field (each carrying exactly one id)."""
    out = [slot("label", type="uint64"),
           slot("dense", type="float32", is_dense=True, dense_dim=dense_dim)]
    out += [slot("field_%d" % i) for i in range(num_fields)]
    return out


class CTRMultiSlotReader(CheckpointableReader):
    """MultiSlot CTR shards -> the DeepFM bench feed, schema-validated.

    Each line must carry the :func:`ctr_slots` layout; the per-field
    single ids are packed into one ``ids [B, num_fields] int64`` tensor
    (the ``models.deepfm`` contract). A line whose field slot carries 0 or
    >1 ids, a dense slot of the wrong width, an id >= ``vocab`` — all are
    corrupt RECORDS: quarantined and skipped, never a crash."""

    def __init__(self, shards: Sequence[str], batch_size: int,
                 num_fields: int = 26, dense_dim: int = 13,
                 vocab: Optional[int] = None, **kw):
        slots = ctr_slots(num_fields, dense_dim)
        self.num_fields = int(num_fields)
        self.dense_dim = int(dense_dim)
        self.vocab = vocab
        base = _multislot_parse_fn(slots)

        def parse(line: str) -> Dict[str, np.ndarray]:
            rec = base(line)
            ids = np.empty((num_fields,), np.int64)
            for i in range(num_fields):
                v = rec["field_%d" % i]
                if len(v) != 1:
                    raise ValueError("field_%d carries %d ids, expected 1"
                                     % (i, len(v)))
                ids[i] = v[0]
            if vocab is not None and ((ids < 0).any() or
                                      (ids >= vocab).any()):
                raise ValueError("id out of range [0, %d)" % vocab)
            return {"ids": ids,
                    "dense": rec["dense"].astype(np.float32),
                    "label": rec["label"].astype(np.int64)}

        schema = [FieldSpec("ids", (num_fields,), np.int64),
                  FieldSpec("dense", (dense_dim,), np.float32),
                  FieldSpec("label", (1,), np.int64)]
        super().__init__(shards, parse, batch_size, schema=schema, **kw)


def write_ctr_shards(dirname: str, n_records: int, n_shards: int = 2,
                     num_fields: int = 26, dense_dim: int = 13,
                     vocab: int = 1000, seed: int = 0,
                     prefix: str = "ctr") -> List[str]:
    """Synthetic CTR MultiSlot shards for benches/tests/drills; returns
    the shard paths. Deterministic per (seed, geometry)."""
    os.makedirs(dirname, exist_ok=True)
    rng = np.random.RandomState(seed)
    per = (n_records + n_shards - 1) // n_shards
    paths = []
    written = 0
    for si in range(n_shards):
        path = os.path.join(dirname, "%s_%05d.txt" % (prefix, si))
        with open(path, "w") as f:
            for _ in range(min(per, n_records - written)):
                parts = ["1 %d" % rng.randint(0, 2)]
                parts.append("%d %s" % (dense_dim, " ".join(
                    "%.6f" % v for v in rng.rand(dense_dim))))
                for _f in range(num_fields):
                    parts.append("1 %d" % rng.randint(0, vocab))
                f.write(" ".join(parts) + "\n")
                written += 1
        paths.append(path)
    return paths
