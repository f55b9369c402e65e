# ported from paddle_tpu/data/reader.py
"""CheckpointableReader — deterministic, exactly-once, corruption-tolerant
ingestion over sharded record streams.

The host-side half of self-healing training (reference: the AsyncExecutor
MultiSlot readers of the source framework, SURVEY L4 — re-shaped so the
stream position is *state*, not a side effect):

* **Exactly-once across kill/resume.** The reader's full position —
  epoch, shard index, record index, lifetime counters, quarantined ids —
  is a JSON-serializable :meth:`~CheckpointableReader.state_dict`, the
  JAX package's JSON at every position; a reader that loads it resumes
  at the next unread record. (The JAX package's ``run_supervised``
  persists it in its checkpoints; the supervisor is not ported yet.)
* **Corrupt records are data, not crashes.** Every record passes typed
  parse/shape/dtype validation; a failure is skipped, appended to a
  quarantine JSONL (record id + reason) and counted (``data/*``). A
  corrupt *rate* above ``max_corrupt_rate`` raises the typed
  :class:`DataCorruptionError` instead of silently starving the trainer.
* **Quarantine is addressable.** Record ids are stable
  (``<shard-basename>#<line>``), so the divergence sentinel can quarantine
  the exact data window that preceded a loss blow-up and the reader will
  skip those records on every subsequent pass.
* **Backpressured prefetch.** :meth:`~CheckpointableReader.prefetch`
  parses ahead on a bounded queue without giving up checkpointability;
  its output composes with :class:`~paddle_tpu_torch.reader.DevicePrefetcher`
  for the host-to-device overlap.

Restore cost note: positions are record-indexed (not byte offsets), so
``load_state_dict`` re-reads and discards ``record`` lines of the current
shard — O(position within one shard), never O(stream).
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from . import metrics as _dm

__all__ = [
    "FieldSpec", "RecordError", "DataCorruptionError",
    "CheckpointableReader", "PrefetchReader",
]

STATE_VERSION = 1


class RecordError(ValueError):
    """One record failed parse/shape/dtype validation. Carries the stable
    record id and the reason that lands in the quarantine JSONL."""

    def __init__(self, record_id: str, reason: str):
        super().__init__("record %s: %s" % (record_id, reason))
        self.record_id = record_id
        self.reason = reason


class DataCorruptionError(RuntimeError):
    """The stream's corrupt-record rate exceeded the configured bound —
    the data source itself is broken (truncated upload, format drift),
    and training on the survivors would be silent garbage. Typed so the
    supervisor's classify() treats it as fatal, never retried."""


class FieldSpec:
    """Declarative per-record validation for one feed field: ``shape`` is
    the PER-RECORD shape (batching adds the leading axis); ``None`` dims
    are wildcards (variable-length slots)."""

    __slots__ = ("name", "shape", "dtype")

    def __init__(self, name: str, shape: Sequence[Optional[int]], dtype):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)

    def validate(self, record_id: str, value) -> np.ndarray:
        arr = np.asarray(value)
        if arr.dtype != self.dtype:
            raise RecordError(record_id, "field %r dtype %s != declared %s"
                              % (self.name, arr.dtype, self.dtype))
        if len(arr.shape) != len(self.shape) or any(
                d is not None and d != a
                for d, a in zip(self.shape, arr.shape)):
            raise RecordError(record_id, "field %r shape %s != declared %s"
                              % (self.name, arr.shape, self.shape))
        return arr

    def __repr__(self):
        return "FieldSpec(%r, %r, %s)" % (self.name, self.shape, self.dtype)


def _stack_collate(records: List[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
    """Default collation: stack each field on a new leading batch axis
    (fixed per-record shapes; MultiSlot's padded+length collation handles
    the variable-length case)."""
    return {name: np.stack([r[name] for r in records])
            for name in records[0]}


class CheckpointableReader:
    """Iterate batches (feed dicts) over sharded line-record files with a
    fully serializable position.

    ``shards``: ordered file paths (one record per line; blank lines are
    skipped). ``parse_fn(line) -> dict[str, array-like]`` produces one
    record; any exception it raises marks the record corrupt. ``schema``
    (a list of :class:`FieldSpec`) adds typed shape/dtype validation.
    ``epochs=None`` cycles forever. A yielded batch is ``batch_size``
    records collated by ``collate_fn`` (default: ``np.stack`` per field);
    a final partial batch is dropped unless ``drop_remainder=False``.
    """

    def __init__(self, shards: Sequence[str],
                 parse_fn: Callable[[str], Dict[str, Any]],
                 batch_size: int,
                 schema: Optional[Sequence[FieldSpec]] = None,
                 epochs: Optional[int] = 1,
                 collate_fn: Optional[Callable[[List[Dict[str, np.ndarray]]],
                                               Dict[str, np.ndarray]]] = None,
                 quarantine_path: Optional[str] = None,
                 max_corrupt_rate: float = 0.01,
                 corrupt_check_min: int = 100,
                 drop_remainder: bool = True,
                 id_history: int = 64):
        if not shards:
            raise ValueError("CheckpointableReader needs at least one shard")
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.shards = [str(s) for s in shards]
        names = [os.path.basename(s) for s in self.shards]
        if len(set(names)) != len(names):
            # record ids are <basename>#<line>; colliding basenames would
            # alias quarantine entries across shards
            raise ValueError("shard basenames must be unique: %r" % names)
        self.parse_fn = parse_fn
        self.batch_size = int(batch_size)
        self.schema = list(schema) if schema else None
        self.epochs = epochs if epochs is None else int(epochs)
        self.collate_fn = collate_fn if collate_fn is not None \
            else _stack_collate
        self.quarantine_path = quarantine_path
        self.max_corrupt_rate = float(max_corrupt_rate)
        self.corrupt_check_min = int(corrupt_check_min)
        self.drop_remainder = bool(drop_remainder)
        # -- position (everything state_dict carries) --
        self._epoch = 0
        self._shard = 0          # index into self.shards
        self._record = 0         # next line index within the current shard
        self._records_read = 0
        self._records_corrupt = 0
        self._records_skipped = 0
        self._batches = 0
        self._skip_ids: set = set()
        # -- transient --
        self._fh = None
        self._exhausted = False
        self._ids_history: deque = deque(maxlen=max(1, int(id_history)))

    # -- record ids -----------------------------------------------------------
    def _rid(self, shard_idx: int, line_idx: int) -> str:
        return "%s#%d" % (os.path.basename(self.shards[shard_idx]), line_idx)

    # -- quarantine -----------------------------------------------------------
    def quarantine(self, ids: Sequence[str], reason: str) -> None:
        """Append ``ids`` to the quarantine JSONL (one ``{"id", "reason"}``
        row each) and add them to the skip set, so every later pass —
        including a sentinel rollback replay — drops them. Public: the
        divergence sentinel quarantines whole data windows through this."""
        ids = list(ids)
        if not ids:
            return
        self._skip_ids.update(ids)
        _dm.RECORDS_QUARANTINED.inc(len(ids))
        if self.quarantine_path:
            with open(self.quarantine_path, "a") as f:
                for rid in ids:
                    f.write(json.dumps({"id": rid, "reason": reason}) + "\n")

    def quarantined_ids(self) -> List[str]:
        return sorted(self._skip_ids)

    def _quarantine_corrupt(self, err: RecordError) -> None:
        self._records_corrupt += 1
        _dm.RECORDS_CORRUPT.inc()
        self.quarantine([err.record_id], err.reason)
        seen = self._records_read + self._records_corrupt
        if seen >= self.corrupt_check_min and \
                self._records_corrupt > self.max_corrupt_rate * seen:
            raise DataCorruptionError(
                "corrupt-record rate %.4f (%d of %d) exceeds the %.4f "
                "bound — refusing to train on the survivors (last: %s)"
                % (self._records_corrupt / seen, self._records_corrupt,
                   seen, self.max_corrupt_rate, err)) from err

    # -- raw line stream ------------------------------------------------------
    def _open_current(self):
        if self._fh is None:
            self._fh = open(self.shards[self._shard], "r")
            for _ in range(self._record):  # record-indexed restore
                self._fh.readline()
        return self._fh

    def _next_line(self) -> Optional[Tuple[str, str]]:
        """(record_id, line) of the next non-blank line, advancing the
        position; None when the configured epochs are exhausted."""
        while not self._exhausted:
            fh = self._open_current()
            line = fh.readline()
            if line:
                rid = self._rid(self._shard, self._record)
                self._record += 1
                _dm.BYTES_READ.inc(len(line))
                if not line.strip():
                    continue
                return rid, line.rstrip("\n")
            # shard exhausted
            fh.close()
            self._fh = None
            self._record = 0
            self._shard += 1
            if self._shard >= len(self.shards):
                self._shard = 0
                self._epoch += 1
                _dm.EPOCHS_COMPLETED.inc()
                if self.epochs is not None and self._epoch >= self.epochs:
                    self._exhausted = True
        return None

    # -- records --------------------------------------------------------------
    def _parse_validate(self, rid: str, line: str) -> Dict[str, np.ndarray]:
        try:
            rec = self.parse_fn(line)
        except Exception as e:
            raise RecordError(rid, "parse: %s: %s" % (type(e).__name__, e))
        if not isinstance(rec, dict) or not rec:
            raise RecordError(rid, "parse_fn returned %r, not a non-empty "
                                   "field dict" % type(rec).__name__)
        if self.schema is not None:
            out = {}
            for spec in self.schema:
                if spec.name not in rec:
                    raise RecordError(rid, "missing field %r" % spec.name)
                out[spec.name] = spec.validate(rid, rec[spec.name])
            return out
        return {k: np.asarray(v) for k, v in rec.items()}

    def _next_record(self) -> Optional[Tuple[str, Dict[str, np.ndarray]]]:
        while True:
            nxt = self._next_line()
            if nxt is None:
                return None
            rid, line = nxt
            if rid in self._skip_ids:
                self._records_skipped += 1
                _dm.RECORDS_SKIPPED.inc()
                continue
            try:
                rec = self._parse_validate(rid, line)
            except RecordError as e:
                self._quarantine_corrupt(e)  # may raise DataCorruptionError
                continue
            self._records_read += 1
            _dm.RECORDS_READ.inc()
            return rid, rec

    # -- iteration ------------------------------------------------------------
    def __iter__(self) -> "CheckpointableReader":
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        records: List[Dict[str, np.ndarray]] = []
        ids: List[str] = []
        while len(records) < self.batch_size:
            nxt = self._next_record()
            if nxt is None:
                if records and not self.drop_remainder:
                    break
                raise StopIteration
            rid, rec = nxt
            ids.append(rid)
            records.append(rec)
        self._batches += 1
        _dm.BATCHES.inc()
        self._ids_history.append(ids)
        return self.collate_fn(records)

    def last_batch_ids(self, n: int = 1) -> List[List[str]]:
        """Record ids of the last ``n`` yielded batches, oldest first —
        the sentinel's handle on "the data window that preceded the trip"
        (bounded by ``id_history``)."""
        hist = list(self._ids_history)
        return hist[-n:] if n > 0 else []

    # -- checkpointable position ----------------------------------------------
    def state_dict(self) -> dict:
        """The FULL position after the last yielded batch, JSON-ready —
        what ``run_supervised`` folds into every rotating checkpoint."""
        return {
            "version": STATE_VERSION,
            "shards": [os.path.basename(s) for s in self.shards],
            "epoch": self._epoch,
            "shard": self._shard,
            "record": self._record,
            "records_read": self._records_read,
            "records_corrupt": self._records_corrupt,
            "records_skipped": self._records_skipped,
            "batches": self._batches,
            "skip_ids": sorted(self._skip_ids),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore an exact stream position (same shard set). The open file
        handle, lookahead and id history are reset; reading resumes at the
        recorded record index."""
        if state.get("version") != STATE_VERSION:
            raise ValueError("reader state version %r != %d"
                             % (state.get("version"), STATE_VERSION))
        names = [os.path.basename(s) for s in self.shards]
        if state.get("shards") != names:
            raise ValueError(
                "reader state was taken over shards %r, this reader has %r "
                "— resuming would consume different records"
                % (state.get("shards"), names))
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._epoch = int(state["epoch"])
        self._shard = int(state["shard"])
        self._record = int(state["record"])
        self._records_read = int(state["records_read"])
        self._records_corrupt = int(state["records_corrupt"])
        self._records_skipped = int(state["records_skipped"])
        self._batches = int(state["batches"])
        self._skip_ids = set(state.get("skip_ids", ()))
        self._exhausted = (self.epochs is not None
                           and self._epoch >= self.epochs)
        self._ids_history.clear()

    # -- stats / prefetch -----------------------------------------------------
    @property
    def records_read(self) -> int:
        return self._records_read

    @property
    def records_corrupt(self) -> int:
        return self._records_corrupt

    def prefetch(self, capacity: int = 4) -> "PrefetchReader":
        """Parse ahead on a bounded background queue (backpressure: the
        worker blocks when ``capacity`` batches are ready). The wrapper
        stays checkpointable — its ``state_dict`` is the position of the
        last batch the CONSUMER saw, not whatever the worker read ahead —
        and composes with ``DevicePrefetcher`` for the H2D overlap::

            feed = DevicePrefetcher(reader.prefetch(4), capacity=2)
        """
        return PrefetchReader(self, capacity)


class PrefetchReader:
    """Bounded parse-ahead over a :class:`CheckpointableReader` that
    PRESERVES the checkpoint contract: every queued batch rides with the
    reader state *after* it was produced, so ``state_dict()`` reflects
    exactly the batches the consumer has been handed. ``quarantine`` and
    ``load_state_dict`` rewind the overread (worker stopped, queue dropped,
    inner reader restored) before acting, so sentinel rollback works the
    same with or without prefetch."""

    _END = object()

    def __init__(self, reader: CheckpointableReader, capacity: int = 4):
        import queue as _q
        import threading as _t

        self.reader = reader
        self._capacity = max(1, int(capacity))
        self._queue_mod = _q
        self._thread_mod = _t
        self._q = _q.Queue(maxsize=self._capacity)
        self._thread = None
        self._stop = _t.Event()
        self._err: Optional[BaseException] = None
        self._last_state = reader.state_dict()
        self._ids_history: deque = deque(maxlen=reader._ids_history.maxlen)

    # -- worker ---------------------------------------------------------------
    def _worker(self):
        try:
            while not self._stop.is_set():
                try:
                    batch = next(self.reader)
                except StopIteration:
                    break
                item = (batch, self.reader.state_dict(),
                        self.reader.last_batch_ids(1)[0])
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.05)
                        break
                    except self._queue_mod.Full:
                        continue
        except BaseException as e:  # DataCorruptionError et al: re-raised
            self._err = e           # in the consumer with its traceback
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(self._END, timeout=0.05)
                    break
                except self._queue_mod.Full:
                    continue

    def _ensure_started(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = self._thread_mod.Thread(
                target=self._worker, daemon=True)
            self._thread.start()

    def _halt(self):
        """Stop the worker and drop its read-ahead (consumer-side state is
        authoritative; the dropped batches are re-read after restore)."""
        if self._thread is None:
            return
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except self._queue_mod.Empty:
                break
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            # refuse to touch the inner reader under a live worker: a
            # restore racing a stuck parse would corrupt the position
            raise RuntimeError(
                "PrefetchReader: worker did not stop within 30s (parse_fn "
                "or shard read stuck?) — cannot safely restore/quarantine")
        self._thread = None
        self._q = self._queue_mod.Queue(maxsize=self._capacity)

    # -- iteration ------------------------------------------------------------
    def __iter__(self) -> "PrefetchReader":
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        import time as _time

        self._ensure_started()
        from ..monitor import metrics as _mx

        if _mx.enabled():
            _dm.PREFETCH_DEPTH.set(self._q.qsize())
            t0 = _time.perf_counter()
            item = self._q.get()
            _dm.PREFETCH_WAIT_MS.observe((_time.perf_counter() - t0) * 1e3)
        else:
            item = self._q.get()
        if item is self._END:
            self._thread = None
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        batch, state, ids = item
        self._last_state = state
        self._ids_history.append(ids)
        return batch

    # -- checkpointable contract ----------------------------------------------
    def state_dict(self) -> dict:
        return self._last_state

    def load_state_dict(self, state: dict) -> None:
        self._halt()
        self.reader.load_state_dict(state)
        self._last_state = self.reader.state_dict()
        self._ids_history.clear()

    def last_batch_ids(self, n: int = 1) -> List[List[str]]:
        hist = list(self._ids_history)
        return hist[-n:] if n > 0 else []

    def quarantine(self, ids: Sequence[str], reason: str) -> None:
        # rewind the overread first: quarantined records the worker already
        # parsed past must be re-read (and now skipped) after restore
        self._halt()
        self.reader.load_state_dict(self._last_state)
        self.reader.quarantine(ids, reason)
        self._last_state = self.reader.state_dict()

    def quarantined_ids(self) -> List[str]:
        return self.reader.quarantined_ids()

    def stop(self) -> None:
        """Release the worker thread (idempotent; context-manager exit)."""
        self._halt()

    def __enter__(self) -> "PrefetchReader":
        self._ensure_started()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
