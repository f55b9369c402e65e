# ported from paddle_tpu/serving/scheduler.py
"""Continuous (in-flight) batching scheduler: requests ↔ fixed batch slots.

The request multiplexer of the serving stack (the AsyncExecutor/DataFeed
ingestion role from the reference, SURVEY L4, re-shaped for autoregressive
decode): a bounded FIFO queue feeds ``n_slots`` fixed batch-bucket slots.
Each decode step the engine retires finished slots and admits queued
requests into the holes, so new requests join the running batch mid-flight
instead of waiting for it to drain. ``continuous=False`` degrades to the
classic static-batch policy — admit only when EVERY slot is free, drain the
whole wave — which is exactly the padded baseline ``bench.py --serve``
compares against.

Pure host-side bookkeeping (no device state) so its invariants are testable
under churn without compiling anything; the engine owns pages and device
arrays.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional

from . import metrics as _sm
from .request import (FAILED, FINISHED, QUEUED, REJECTED, RUNNING,
                      TIMEOUT, BackpressureError, Request)

__all__ = ["Scheduler"]


class Scheduler:
    def __init__(self, n_slots: int, max_queue: int = 1024,
                 continuous: bool = True):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = int(n_slots)
        self.max_queue = int(max_queue)
        self.continuous = bool(continuous)
        self._queue: Deque[Request] = deque()
        self._slots: List[Optional[Request]] = [None] * self.n_slots

    # -- introspection --------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def occupancy(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    def running(self) -> List[Request]:
        return [r for r in self._slots if r is not None]

    def slot_request(self, slot: int) -> Optional[Request]:
        return self._slots[slot]

    def idle(self) -> bool:
        return not self._queue and self.occupancy == 0

    # -- queue side -----------------------------------------------------------
    def submit(self, req: Request) -> Request:
        """Enqueue; raises :class:`BackpressureError` when the bounded queue
        is full (the caller sheds load — nothing was accepted)."""
        if len(self._queue) >= self.max_queue:
            _sm.REQUESTS_REJECTED.inc()
            raise BackpressureError(
                "serving queue full (%d requests); retry later"
                % self.max_queue)
        if req.state != QUEUED:
            raise ValueError("cannot submit request in state %r" % req.state)
        self._queue.append(req)
        _sm.REQUESTS_SUBMITTED.inc()
        _sm.QUEUE_DEPTH.set(len(self._queue))
        return req

    def peek(self) -> Optional[Request]:
        return self._queue[0] if self._queue else None

    def peek_n(self, n: int) -> List[Request]:
        """The first ``n`` queued requests (fewer if the queue is shorter) —
        the static wave policy sizes its padding bucket from these."""
        return [self._queue[i] for i in range(min(n, len(self._queue)))]

    # -- slot side ------------------------------------------------------------
    def admissible_slots(self) -> List[int]:
        """Slots the policy allows filling now: any free slot when
        continuous, and only a fully-drained batch otherwise."""
        free = [i for i, r in enumerate(self._slots) if r is None]
        if not self.continuous and len(free) != self.n_slots:
            return []
        return free

    def admit(self, slot: int) -> Request:
        """Move the queue head into ``slot`` (caller has already secured
        pages). FIFO by construction — admission order is submission order."""
        if self._slots[slot] is not None:
            raise ValueError("slot %d already occupied by %r"
                             % (slot, self._slots[slot]))
        if not self._queue:
            raise ValueError("admit() with an empty queue")
        req = self._queue.popleft()
        req.state = RUNNING
        req.slot = slot
        self._slots[slot] = req
        _sm.REQUESTS_ADMITTED.inc()
        _sm.QUEUE_DEPTH.set(len(self._queue))
        _sm.SLOT_OCCUPANCY.set(self.occupancy)
        return req

    def requeue_head_blocked(self) -> None:
        """Admission blocked on resources (pages): the head STAYS at the
        head — FIFO order survives backpressure, later smaller requests do
        not starve an early big one ... they wait behind it."""
        _sm.ADMISSION_BLOCKED.inc()

    def retire(self, slot: int, state: str = FINISHED) -> Request:
        """Vacate ``slot``; ``state`` is the request's terminal state —
        FINISHED (default), TIMEOUT (deadline) or FAILED (batch lost to a
        decode failure). Every path counts as a retirement (the slot was
        reclaimed); the engine keeps the per-cause counters."""
        req = self._slots[slot]
        if req is None:
            raise ValueError("retire() on empty slot %d" % slot)
        if state not in (FINISHED, TIMEOUT, FAILED):
            raise ValueError("invalid terminal state %r" % state)
        self._slots[slot] = None
        req.state = state
        req.slot = None
        _sm.REQUESTS_RETIRED.inc()
        _sm.SLOT_OCCUPANCY.set(self.occupancy)
        return req

    def drain_queue(self) -> List[Request]:
        """Graceful-drain shutdown of the QUEUE side: every queued request
        leaves with terminal state REJECTED (it never held a slot or
        pages; the caller re-routes it to a peer engine). Running slots
        are the engine's to finish — that is the point of draining."""
        out = list(self._queue)
        self._queue.clear()
        for r in out:
            r.state = REJECTED
        if out:
            _sm.DRAIN_REJECTED.inc(len(out))
            _sm.QUEUE_DEPTH.set(0)
        return out

    def drop_expired(self, now: float) -> List[Request]:
        """Remove queued requests whose deadline passed (they never got a
        slot); returns them, terminal state set to TIMEOUT. Running
        requests' deadlines are the engine's to enforce — it owns their
        pages and device state."""
        expired = [r for r in self._queue if r.expired(now)]
        if expired:
            keep = [r for r in self._queue if not r.expired(now)]
            self._queue.clear()
            self._queue.extend(keep)
            for r in expired:
                r.state = TIMEOUT
            _sm.QUEUE_DEPTH.set(len(self._queue))
        return expired
