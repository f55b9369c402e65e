# ported from paddle_tpu/reader/prefetcher.py
"""Device prefetcher — the double-buffer reader.

Reference: ``operators/reader/buffered_reader.cc`` (create_double_buffer
reader: an async H2D copy on a dedicated stream) and py_reader's
``LoDTensorBlockingQueue``. A background thread copies the NEXT feed dict
to the card while the current step computes:

* it stages each array in pinned host memory, from a small ring of pinned
  buffers per feed name (grown when a batch needs more bytes) — a slot is
  refilled only after the copy that last read it has completed, so a
  batch pays no ``cudaHostAlloc`` once the ring is grown and no buffer is
  rewritten under a copy in flight;
* it issues ``copy_(non_blocking=True)`` into fresh device tensors on a
  stream of its own (made on the target device, which the thread makes
  its current device) and records a ``torch.cuda.Event`` after the
  batch's copies;
* the consumer makes its current stream wait on that event before it
  yields the dict, and ``record_stream``\\ s each tensor on that stream,
  so the step that reads a batch is ordered after its copy and the
  caching allocator does not reuse a batch's memory while the step still
  reads it.

While a CUDA graph is captured (the executor's captured step) the worker
issues no CUDA call: the capture and each batch's staging and copies hold
:data:`CAPTURE_LOCK`. A capture in ``torch.cuda.graph``'s default global
mode fails on an unsafe call (``cudaMalloc``, ``cudaHostAlloc``, an event
synchronize) from any thread, and the lock keeps the worker out of it.

With ``device="cpu"`` it hands over CPU tensors (copies of the arrays),
with no stream.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..core.place import resolve_device
from ..monitor import metrics as _mx

__all__ = ["DevicePrefetcher", "CAPTURE_LOCK"]

_m_depth = _mx.gauge("prefetcher/queue_depth",
                     help="ready-on-device batches buffered ahead")
_m_h2d_ms = _mx.histogram("prefetcher/h2d_ms",
                          help="host→device put dispatch time per batch")
_m_wait_ms = _mx.histogram("prefetcher/wait_time_ms",
                           help="consumer wait for the next device batch")
_m_copy_ms = _mx.histogram(
    "prefetcher/copy_ms",
    help="device time of a batch's host→device copies on the side stream")

# held by a CUDA graph capture and by the worker around a batch's CUDA calls
CAPTURE_LOCK = threading.Lock()

# pinned staging buffers per feed name; a slot is refilled after the copy
# that read it completes
RING_SLOTS = 2


def _host_array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(v))


class _Stager:
    """The worker's CUDA side: its stream, the pinned ring and, with
    metrics on, the timing events of the copies still unread."""

    def __init__(self, device: torch.device, timed: bool):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.ring: Dict[tuple, list] = {}
        self.timed = timed
        self.inflight: collections.deque = collections.deque()

    def _slot(self, name, nbytes: int):
        """The next ring slot of feed ``name``, its copy done, holding at
        least ``nbytes`` of pinned memory (a buffer that is too small is
        replaced, so a feed whose shape changes keeps ``RING_SLOTS``
        buffers)."""
        slots = self.ring.setdefault(name, [])
        if len(slots) < RING_SLOTS:
            slot = [None, None]
            slots.append(slot)
        else:
            slot = slots.pop(0)
            slots.append(slot)
            if slot[1] is not None:
                slot[1].synchronize()  # the copy that last read it is done
        if slot[0] is None or slot[0].numel() < nbytes:
            slot[0] = torch.empty(max(1, nbytes), dtype=torch.uint8,
                                  pin_memory=True)
        return slot

    def copy(self, feed) -> tuple:
        """``feed`` on the card: ({name: tensor}, the event after its
        copies). The arrays are staged first, so with metrics on the timing
        events hold the copies alone."""
        out, staged, on_card = {}, [], {}
        for k, v in feed.items():
            if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                on_card[k] = v
                continue
            arr = _host_array(v)
            slot = self._slot(k, arr.nbytes)
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            host = slot[0][:arr.nbytes].view(dtype).view(arr.shape)
            host.numpy()[...] = arr
            staged.append((k, slot, host))
        with torch.cuda.stream(self.stream):
            out.update({k: v.to(self.device) for k, v in on_card.items()})
            for k, _, host in staged:
                out[k] = torch.empty(host.shape, dtype=host.dtype,
                                     device=self.device)
            start = None
            if self.timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record(self.stream)
            for k, _, host in staged:
                out[k].copy_(host, non_blocking=True)
            done = torch.cuda.Event(enable_timing=self.timed)
            done.record(self.stream)
        for _, slot, _ in staged:
            slot[1] = done
        if self.timed:
            self.inflight.append((start, done))
            while len(self.inflight) > RING_SLOTS:
                self._observe()
        return out, done

    def _observe(self):
        start, done = self.inflight.popleft()
        done.synchronize()
        _m_copy_ms.observe(start.elapsed_time(done))

    def finish(self):
        while self.inflight:
            self._observe()


class DevicePrefetcher:
    """Wrap an iterator of feed dicts; yields dicts whose tensors are
    already on the device.

        for feed in DevicePrefetcher(feed_iter(), capacity=2):
            exe.run(main, feed=feed, fetch_list=[loss])

    ``device`` None is the card (``cuda:0``'s current device), and raises
    ``RuntimeError`` without one; ``device="cpu"`` hands over CPU tensors.

    Also a context manager: ``with DevicePrefetcher(...) as pf:`` guarantees
    the worker thread is stopped (and its buffered device batches dropped)
    when the block exits, even if the consumer abandons the loop early —
    without ``stop()``, a walked-away-from iterator would leave the worker
    blocked on a full queue forever, pinning ``capacity`` batches of device
    memory. Worker exceptions surface in the consumer with the worker's
    original traceback, as soon as the failing batch's slot is reached.
    """

    _END = object()

    def __init__(self, feeds: Iterator[Dict[str, np.ndarray]], capacity: int = 2,
                 device=None):
        self._src = feeds
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._device = resolve_device(device)
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._finished = False  # consumer saw _END: source exhausted

    @property
    def device(self) -> torch.device:
        return self._device

    def _put(self, item) -> bool:
        """Queue.put that stays responsive to stop(); False = stopping."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _cpu_copy(self, feed):
        return {k: v.detach().clone() if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v)) for k, v in feed.items()}, \
            None

    def _worker(self):
        stager = None
        try:
            if self._device.type == "cuda":
                # a thread's current device is its own
                torch.cuda.set_device(self._device)
                with CAPTURE_LOCK:
                    stager = _Stager(self._device, _mx.enabled())
            for feed in self._src:
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                if stager is None:
                    out = self._cpu_copy(feed)
                else:
                    with CAPTURE_LOCK:
                        out = stager.copy(feed)
                if _mx.enabled():
                    _m_h2d_ms.observe((time.perf_counter() - t0) * 1e3)
                if not self._put(out):
                    return
        except BaseException as e:  # propagate into the consumer
            # __traceback__ rides along, so the consumer's re-raise shows
            # the worker frame that actually failed, not this one
            self._err = e
        finally:
            if stager is not None:
                # the last copies' times, and the pinned ring freed, outside
                # any capture
                with CAPTURE_LOCK:
                    try:
                        stager.finish()
                    finally:
                        stager = None
            self._put(self._END)

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "DevicePrefetcher":
        """Start the background H2D thread (idempotent; __iter__ calls it)."""
        if self._stop.is_set():
            raise RuntimeError("DevicePrefetcher was stopped; create a new one")
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the worker and release its buffered device batches.

        Safe to call from any state (not started / mid-iteration / already
        stopped). After stop() the iterator terminates; a worker blocked on
        the full queue is unblocked and exits instead of holding device
        buffers for the life of the process.
        """
        self._stop.set()
        q = self._q
        while True:  # drop buffered batches so a blocked worker can exit
            try:
                q.get_nowait()
            except queue.Empty:
                break
        try:
            # wake a consumer blocked in q.get(): the drain above may have
            # swallowed the worker's _END, and a stopped worker won't enqueue
            # another one
            q.put_nowait(self._END)
        except queue.Full:
            pass
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=1.0)

    def __enter__(self) -> "DevicePrefetcher":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    def _raise_worker_error(self):
        err = self._err
        self._err = None
        # re-raising the stored exception keeps the worker thread's original
        # traceback (its __traceback__) under this consumer-side frame
        raise err

    def _hand_over(self, item):
        """The feed of a queued (feed, event): on the card, the consumer's
        current stream waits for the batch's copies and each tensor is
        recorded as used on it."""
        feed, done = item
        if done is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(done)
            for t in feed.values():
                t.record_stream(cur)
        return feed

    def __iter__(self):
        if self._finished:
            # source already drained: a second epoch loop over the same
            # prefetcher terminates immediately (there is one worker per
            # prefetcher, so waiting on the queue would block forever)
            return
        self.start()
        while True:
            if self._stop.is_set():
                if self._err is not None:
                    self._raise_worker_error()
                return
            if _mx.enabled():
                _m_depth.set(self._q.qsize())
                t0 = time.perf_counter()
                item = self._q.get()
                _m_wait_ms.observe((time.perf_counter() - t0) * 1e3)
            else:
                item = self._q.get()
            if item is self._END:
                self._finished = True
                if self._err is not None:
                    self._raise_worker_error()
                return
            yield self._hand_over(item)
