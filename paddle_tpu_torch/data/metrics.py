# ported from paddle_tpu/data/metrics.py
"""data/* instruments: the monitor-registry face of the ingestion pipeline.

One module owns every ``data/*`` name so the reader, the prefetch wrapper
and the MultiSlot parser never race a get-or-create, and tools
(``tools/dump_metrics --selftest``) can assert the full set exists by
importing this module alone. Same hot-path contract as the serving
instruments: module-level handles, a single disabled-branch per call.
"""

from __future__ import annotations

from ..monitor import metrics as _mx

__all__ = [
    "RECORDS_READ", "RECORDS_CORRUPT", "RECORDS_SKIPPED",
    "RECORDS_QUARANTINED", "BATCHES", "BYTES_READ", "EPOCHS_COMPLETED",
    "PREFETCH_DEPTH", "PREFETCH_WAIT_MS",
]

RECORDS_READ = _mx.counter(
    "data/records_read", help="records parsed, validated and batched")
RECORDS_CORRUPT = _mx.counter(
    "data/records_corrupt",
    help="records that failed parse/shape/dtype validation (skipped and "
         "quarantined, never trained on)")
RECORDS_SKIPPED = _mx.counter(
    "data/records_skipped",
    help="records skipped because a previous quarantine listed their id "
         "(corrupt records on a later epoch, sentinel-poisoned windows)")
RECORDS_QUARANTINED = _mx.counter(
    "data/records_quarantined",
    help="record ids appended to the quarantine JSONL (validation "
         "failures + divergence-sentinel data windows)")
BATCHES = _mx.counter(
    "data/batches", help="batches yielded by CheckpointableReader")
BYTES_READ = _mx.counter(
    "data/bytes_read", help="raw shard bytes consumed (pre-parse)")
EPOCHS_COMPLETED = _mx.counter(
    "data/epochs_completed", help="full passes over the shard set")
PREFETCH_DEPTH = _mx.gauge(
    "data/prefetch_depth", help="parsed batches buffered ahead of training")
PREFETCH_WAIT_MS = _mx.histogram(
    "data/prefetch_wait_ms",
    help="consumer wait for the next prefetched batch")
