# ported from paddle_tpu/async_executor.py
"""AsyncExecutor — multi-threaded file-fed training (reference:
python/paddle/fluid/async_executor.py:33 + framework/async_executor.h:60,
data_feed.h:49 MultiSlotDataFeed, executor_thread_worker.h).

As in the JAX package: the reference spawns N CPU trainer threads each
with its own scope, racing optimizer updates Hogwild-style. One card runs
one step at a time, so racing updates buy nothing. The N threads here do
what parallelizes on the host: file reading + MultiSlot text parsing +
batch assembly, feeding a bounded queue; one consumer runs the port's
``Executor.run`` on the batches in order (on the card unless ``place``
asks for the CPU). Same API (run(program, data_feed, filelist, thread_num,
fetch, debug)), same MultiSlot on-disk format, deterministic updates
instead of racy ones.

Sparse (variable-length) slots batch to the framework's padded+Length
convention: ``<name>`` [B, Lmax] int64 padded with 0 + ``<name>_length``
[B] — the LoD replacement used across the framework (ops/sequence_ops.py).
Dense slots batch to [B, dim] float32.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional, Sequence

import numpy as np

from .core.framework import Program, default_main_program
from .data_feed_desc import DataFeedDesc
from .executor import Executor

__all__ = ["AsyncExecutor"]


def _parse_multislot_line(line: str, slots):
    """One MultiSlot text line: per slot, <count> then <count> values
    (reference: data_feed.cc MultiSlotDataFeed::ParseOneInstance)."""
    toks = line.split()
    pos = 0
    inst = []
    for s in slots:
        if pos >= len(toks):
            raise ValueError("MultiSlot line ended early at slot %r" % s.name)
        n = int(toks[pos])
        pos += 1
        vals = toks[pos:pos + n]
        if len(vals) != n:
            raise ValueError("slot %r declares %d values, found %d"
                             % (s.name, n, len(vals)))
        pos += n
        if s.type.startswith("uint") or s.type.startswith("int"):
            inst.append(np.asarray([int(v) for v in vals], np.int64))
        else:
            inst.append(np.asarray([float(v) for v in vals], np.float32))
    return inst


def _batch_to_feed(batch, slots):
    feed = {}
    for i, s in enumerate(slots):
        if not s.is_used:
            continue
        col = [inst[i] for inst in batch]
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


class AsyncExecutor:
    """reference: async_executor.py:33."""

    def __init__(self, place=None, run_mode: str = ""):
        self.place = place
        # None is the card, and raises without one (core.place.resolve_device)
        self._exe = Executor(place)

    def run(self, program: Optional[Program], data_feed: DataFeedDesc,
            filelist: Sequence[str], thread_num: int, fetch, mode: str = "",
            debug: bool = False):
        """Train over every file in ``filelist`` with ``thread_num`` parser
        threads. Returns the list of fetched values per batch (the reference
        prints them with debug=True; we both print and return)."""
        if program is None:
            program = default_main_program()
        if isinstance(fetch, str):
            fetch = [fetch]
        if isinstance(filelist, str):
            with open(filelist) as f:
                filelist = [l.strip() for l in f if l.strip()]
        thread_num = max(1, int(thread_num))
        slots = data_feed.slots
        bs = data_feed.batch_size

        files_q: queue.Queue = queue.Queue()
        for fn in filelist:
            files_q.put(fn)
        batches_q: queue.Queue = queue.Queue(maxsize=thread_num * 4)
        errors: List[BaseException] = []
        _END = object()

        def worker():
            try:
                while True:
                    try:
                        fn = files_q.get_nowait()
                    except queue.Empty:
                        return
                    batch = []
                    with open(fn) as f:
                        for line in f:
                            line = line.strip()
                            if not line:
                                continue
                            batch.append(_parse_multislot_line(line, slots))
                            if len(batch) == bs:
                                batches_q.put(_batch_to_feed(batch, slots))
                                batch = []
                    if batch:
                        batches_q.put(_batch_to_feed(batch, slots))
            except BaseException as e:  # surfaced to the caller
                errors.append(e)
            finally:
                batches_q.put(_END)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(thread_num)]
        for t in threads:
            t.start()

        results = []
        done = 0
        while done < thread_num:
            item = batches_q.get()
            if item is _END:
                done += 1
                continue
            vals = self._exe.run(program, feed=item, fetch_list=list(fetch))
            results.append(vals)
            if debug:
                print("AsyncExecutor:", {n: np.asarray(v).ravel()[:4]
                                         for n, v in zip(fetch, vals)})
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results
