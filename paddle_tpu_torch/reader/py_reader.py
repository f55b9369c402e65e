# ported from paddle_tpu/reader/py_reader.py
"""py_reader: async, double-buffered graph input.

Reference: ``python/paddle/fluid/layers/io.py:636 py_reader`` +
``operators/reader/buffered_reader.cc`` + the LoDTensorBlockingQueue. The
reference's design is a C++ blocking queue drained by a ``read`` op inside
the graph; here, as in the JAX package, the graph stays pure — the
Executor drains the queue at step boundaries and feeds the batches as
ordinary feeds. Same UX: ``start()`` / step until ``EOFException`` /
``reset()``.

With ``use_double_buffer`` the source runs under a
:class:`~.prefetcher.DevicePrefetcher` (its queue holds ``capacity``
batches) on the place given to ``decorate_*(..., places=...)``, the card
when none is given, so each batch is already on the device when the
Executor takes it; ``next_feed`` pulls from the prefetcher in the
Executor's thread, so the step's stream waits for that batch's copy.
Without it a thread fills a queue of ``capacity`` numpy batches.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..monitor import metrics as _mx
from .prefetcher import DevicePrefetcher

__all__ = ["PyReader", "EOFException"]

# Input-pipeline health: a queue depth pinned at 0 with a fat wait-time
# histogram = the step loop is input-bound (the buffered_reader starvation
# signal the reference surfaces only via timeline gaps).
_m_queue_depth = _mx.gauge("reader/queue_depth",
                           help="py_reader queue depth at next_feed")
_m_wait_ms = _mx.histogram("reader/wait_time_ms",
                           help="time Executor.run blocked waiting for a batch")
_m_batches = _mx.counter("reader/batches", help="batches drained via next_feed")


class EOFException(Exception):
    """Raised by Executor.run when a started py_reader is exhausted
    (reference: fluid.core.EOFException from the read op)."""


def _first_place(places):
    if isinstance(places, (list, tuple)):
        return places[0] if places else None
    return places


class PyReader:
    """Queue-backed reader bound to a set of data variables.

    Created via ``fluid.layers.py_reader``; the Executor pulls one batch per
    ``run`` for the reader's variables when no explicit feed provides them.
    """

    _END = object()

    def __init__(self, data_vars, capacity: int, use_double_buffer: bool = True,
                 name: Optional[str] = None):
        self.data_vars = list(data_vars)
        self.var_names = [v.name for v in self.data_vars]
        self.capacity = int(capacity)
        self.use_double_buffer = use_double_buffer
        self.name = name
        self._source: Optional[Callable] = None
        self._place = None
        self._q: Optional[queue.Queue] = None
        self._prefetcher = None
        self._it = None
        self._thread: Optional[threading.Thread] = None
        self._err = None
        self._started = False
        self._gen = 0  # incremented by reset() so stale workers die

    # -- decoration (reference: py_reader.decorate_paddle_reader) -------------
    def decorate_paddle_reader(self, reader: Callable, places=None):
        """``reader()`` yields batches as lists of per-sample tuples (the
        output of paddle.batch); samples are stacked per slot."""

        def gen():
            for batch in reader():
                slots = list(zip(*batch))
                yield tuple(np.asarray(np.stack(s)) for s in slots)

        self._source = gen
        self._place = _first_place(places)

    def decorate_tensor_provider(self, reader: Callable, places=None):
        """``reader()`` yields tuples of ready batch arrays, one per var."""

        def gen():
            for batch in reader():
                yield tuple(np.asarray(a) for a in batch)

        self._source = gen
        self._place = _first_place(places)

    decorate_batch_generator = decorate_tensor_provider

    def decorate_sample_list_generator(self, reader: Callable, places=None):
        self.decorate_paddle_reader(reader, places)

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        if self._source is None:
            raise RuntimeError(
                "py_reader has no data source; call decorate_paddle_reader / "
                "decorate_tensor_provider first")
        if self._started:
            raise RuntimeError("py_reader already started; call reset() between epochs")
        self._err = None
        if self.use_double_buffer:
            names = self.var_names

            def feeds():
                for batch in self._source():
                    if len(batch) != len(names):
                        raise ValueError(
                            "py_reader produced %d arrays per batch but is "
                            "bound to %d variables %s"
                            % (len(batch), len(names), names))
                    yield dict(zip(names, batch))

            self._prefetcher = DevicePrefetcher(
                feeds(), capacity=max(1, self.capacity), device=self._place)
            self._it = iter(self._prefetcher)
            self._started = True
            return
        self._q = queue.Queue(maxsize=self.capacity)
        self._started = True
        gen_token = self._gen

        def worker(q=self._q, token=gen_token):
            try:
                for batch in self._source():
                    if self._gen != token:
                        return
                    q.put(batch)
            except Exception as e:
                self._err = e
            finally:
                q.put(self._END)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def reset(self):
        """Stop the current pass (after EOF or mid-epoch) so start() can be
        called again (reference: reader->ReInit())."""
        self._gen += 1
        self._started = False
        if self._prefetcher is not None:
            self._prefetcher.stop()
            self._prefetcher = self._it = None
        q = self._q
        if q is not None:
            while True:  # drain so a blocked worker can exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        self._q = None

    def _next_item(self):
        """The next batch (a dict through the prefetcher, else a tuple), or
        ``_END``."""
        if self._it is not None:
            try:
                return next(self._it)
            except StopIteration:
                return self._END
        return self._q.get()

    # -- executor hook --------------------------------------------------------
    def next_feed(self) -> dict:
        """One batch as {var_name: array}; EOFException when exhausted."""
        if not self._started:
            raise RuntimeError("py_reader not started; call reader.start()")
        on = _mx.enabled()
        if on:
            q = self._q if self._q is not None else self._prefetcher._q
            _m_queue_depth.set(q.qsize())
        t0 = time.perf_counter()
        try:
            item = self._next_item()
        except Exception:  # the source's error, raised by the prefetcher
            self._started = False
            raise
        if item is self._END:
            self._started = False
            if self._err is not None:
                raise self._err
            raise EOFException("py_reader %r exhausted" % (self.name or "py_reader"))
        if on:
            _m_wait_ms.observe((time.perf_counter() - t0) * 1e3)
            _m_batches.inc()
        if isinstance(item, dict):
            return item
        if len(item) != len(self.var_names):
            raise ValueError(
                "py_reader produced %d arrays per batch but is bound to %d "
                "variables %s" % (len(item), len(self.var_names), self.var_names))
        return dict(zip(self.var_names, item))
