# ported from paddle_tpu/data/__init__.py
"""paddle_tpu_torch.data — exactly-once, corruption-tolerant ingestion.

The host-side half of self-healing training (ROADMAP item 5's streaming
ingestion, re-grounded in the reference's AsyncExecutor MultiSlot readers):

* :class:`~.reader.CheckpointableReader` — deterministic batches over
  sharded line-record files whose FULL position (epoch/shard/record,
  counters, quarantined ids) is a JSON ``state_dict``, equal to the JAX
  package's at every position: a reader restored from it resumes
  exactly once. (The JAX package's ``run_supervised`` folds it into its
  checkpoints; the supervisor is not ported yet.)
* Corrupt records (typed parse/shape/dtype validation) are skipped and
  appended to a quarantine JSONL with id + reason; a corrupt rate above
  the bound raises :class:`~.reader.DataCorruptionError` instead of
  silently starving training. Whole data windows are quarantined
  through the same :meth:`~.reader.CheckpointableReader.quarantine`.
* :class:`~.multislot.MultiSlotTextReader` /
  :class:`~.multislot.CTRMultiSlotReader` — the AsyncExecutor MultiSlot
  text format, streamed checkpointably into the DeepFM/CTR bench feed.
* :meth:`~.reader.CheckpointableReader.prefetch` — bounded parse-ahead
  that keeps the checkpoint contract and composes with
  :class:`~paddle_tpu_torch.reader.DevicePrefetcher` for the H2D overlap.

Counters: ``data/*`` (:mod:`~.metrics`), in the port's
``monitor.metrics`` registry.
"""

from . import metrics  # noqa: F401  (registers the data/* instruments)
from .multislot import (  # noqa: F401
    CTRMultiSlotReader, MultiSlotTextReader, ctr_slots, slot,
    write_ctr_shards,
)
from .reader import (  # noqa: F401
    CheckpointableReader, DataCorruptionError, FieldSpec, PrefetchReader,
    RecordError,
)

__all__ = [
    "CheckpointableReader", "PrefetchReader", "FieldSpec",
    "RecordError", "DataCorruptionError",
    "MultiSlotTextReader", "CTRMultiSlotReader", "ctr_slots", "slot",
    "write_ctr_shards", "metrics",
]
