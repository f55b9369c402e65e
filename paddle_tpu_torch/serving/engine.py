# ported from paddle_tpu/serving/engine.py
"""Autoregressive decode driver: continuous batching over a paged KV-cache.

One :class:`ServingEngine` owns:

* a :class:`~.scheduler.Scheduler` (bounded queue → fixed batch slots,
  continuous in-flight admission or the static wave-drain baseline),
* a :class:`~.page_pool.PagePool` + :class:`~.kv_cache.PagedKVCache` (or
  the :class:`~.kv_cache.ContiguousKVCache` reference layout), and an
  optional :class:`~paddle_tpu_torch.fleet.prefix_cache.PrefixCache` of
  donated prompt-prefix pages,
* the step functions: ONE prefill per admitted request, padded to a
  power-of-two prompt bucket as in the JAX package (or, on a prefix-cache
  hit, a row copy of the cached pages and one verify-window forward over
  the prompt's remainder), and a decode dispatch of ``decode_fuse`` steps
  — or, with speculation, a verify window over each slot's draft — whose
  state (KV pages, page tables, slot occupancy, lengths, sampling
  parameters) stays on the device between steps.

Where the JAX package compiles a dispatch into one AOT executable, the
port captures it into a CUDA graph (serving.captured): one graph per
``decode_fuse`` width and one per verify window width, each with or
without the sampler, replayed with one host sync at the dispatch's end,
where the retire/admit decisions need the emitted tokens; and one graph
per prompt bucket for the prefill (``model.prefill``, the prompt's KV
written through its page-table row, the first token sampled at the
prompt's last position) and one per bucket for a prefix-hit resume (the
remainder padded to the bucket, its writes masked past the remainder),
each replayed with one host read of its token. The slot state is static
tensors written in place, never rebound.

Decoding is greedy (``argmax``, first maximum on ties) at temperature 0
and otherwise the JAX package's seeded Gumbel-argmax sampler over a
bit-exact threefry (core.threefry), keyed by (seed, context position).
Failures of a dispatch retry in place when transient and otherwise FAIL
the in-flight batch, and the engine keeps serving. Observability is the
``serving/*`` counters and latency histograms (serving.metrics); traces,
telemetry, SLOs and the flight recorder wait for ``monitor/``'s modules.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import threefry
from ..core.place import resolve_device
from ..ops import attention_ops
from ..reliability import faults as _faults
from . import metrics as _sm
from . import speculative as _speculative
from .captured import CaptureError, CapturedDispatch
from .kv_cache import ContiguousKVCache, PagedKVCache
from .page_pool import PagePool, PagePoolExhausted
from .request import FAILED, FINISHED, TIMEOUT, DrainingError, Request
from .scheduler import Scheduler

__all__ = ["ServingConfig", "ServingEngine"]

# speculation="auto" with no tune table: the JAX package's shipped default
# (paddle_tpu/tune/table.py resolve_speculation_k)
SPEC_AUTO_K = 4


def _pow2_buckets(lo: int, hi: int) -> tuple:
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(sorted(set(out)))


def _greedy_tokens(logits) -> torch.Tensor:
    """``argmax`` over the last axis, the FIRST maximum on ties, as
    ``jnp.argmax`` does."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _sample_tokens(logits, temp, top_k, seed, position) -> torch.Tensor:
    """Device-side per-slot token selection, shared by prefill, resume and
    the decode and verify bodies.

    ``logits`` [B,V]; ``temp``/``top_k``/``seed``/``position`` [B].
    ``temp[b] == 0`` returns EXACTLY ``argmax(logits[b])``, selected by
    ``where``, so greedy requests are bit-identical whether or not sampling
    requests share the batch. ``temp[b] > 0`` draws by the Gumbel-argmax
    trick over the float32 logits divided by ``max(temp, 1e-6)``,
    restricted to the ``top_k[b]`` largest when positive (threshold at the
    k-th of a descending sort; ties at or above it are kept). The draw is
    keyed ``fold_in(PRNGKey(seed[b]), position[b])``: a pure function of
    the request's seed and the absolute context position of the token
    being consumed, so the stream does not depend on ``decode_fuse`` or
    on speculation, and equals the JAX package's. No host read, no
    ``torch.Generator``: it captures."""
    greedy = _greedy_tokens(logits)
    v = logits.shape[-1]
    scaled = logits.float() / temp.float().clamp_min(1e-6)[:, None]
    k = torch.where(top_k > 0, top_k, v).clamp(1, v).long()
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kth = srt.gather(-1, (k - 1)[:, None])
    masked = torch.where(scaled >= kth, scaled,
                         attention_ops.neg_inf_value(torch.float32))
    key = threefry.fold_in(threefry.prng_key(seed), position)
    sampled = _greedy_tokens(masked + threefry.gumbel(key, v))
    return torch.where(temp > 0, sampled, greedy)


class ServingConfig:
    """Engine geometry + policy knobs, the JAX package's arguments.

    ``slots``: fixed decode batch width. ``max_seq``: per-request context
    budget (prompt + generated), a multiple of ``page_size``. ``num_pages``
    defaults to full-occupancy worst case (``slots * max_seq/page_size``);
    size it SMALLER to oversubscribe — admission then backpressures on the
    pool instead of the slots. ``decode_fuse`` runs that many decode steps
    per dispatch (admission/retirement happen at dispatch boundaries);
    ``"auto"`` resolves to 1 with source ``"default"``: the port has no
    tune table yet. ``continuous=False`` degrades to the padded static
    wave-drain baseline; ``paged=False`` swaps in the contiguous reference
    cache. ``eos_id=None`` disables EOS stopping (generation runs to
    ``max_new_tokens``). ``collect_logits`` keeps every emitted token's
    logits row on the host (:meth:`ServingEngine.captured_logits`).

    ``speculation`` arms speculative decoding (serving.speculative): the
    engine-default draft k — ``0`` off, a positive int (capped at
    ``speculative.SPEC_K_CAP``), ``"auto"`` the shipped default k = 4
    (source ``"default"``); ``None`` defers to ``PADDLE_TPU_SPECULATION``.
    ``spec_drafter`` names the drafter (``"ngram"``). Per-request
    ``submit(speculation=...)`` overrides the default.

    ``prefix_cache_pages > 0`` (paged layout) lets that many pool pages
    hold donated prompt-prefix KV (fleet.prefix_cache), LRU-evicted.

    Failure policy: ``decode_retries`` bounds in-place retries of a decode
    dispatch whose failure classifies as transient
    (:func:`paddle_tpu_torch.reliability.faults.classify`); past the
    budget — or on a fatal failure — the in-flight batch is FAILED, its
    pages return to the pool, and the engine keeps serving the queue.
    ``fail_fast=True`` raises instead. ``drain_timeout_s`` bounds
    :meth:`ServingEngine.drain`.

    Port only: ``cuda_graphs=False`` runs every dispatch eagerly on the
    card (the yardstick the graphs are timed against).

    Not ported yet, and raising ``NotImplementedError``: ``slos`` (their
    monitor, ``monitor/slo``, and the telemetry exporter that evaluates
    them) and ``kv_dtype="int8"`` (the int8 pages engage only through a
    calibrated scale from ``monitor.numerics``); both wait for ROADMAP.md
    Queue 1 item 8.
    """

    def __init__(self, slots: int = 8, page_size: int = 16,
                 max_seq: int = 128, num_pages: Optional[int] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 max_queue: int = 1024, eos_id: Optional[int] = None,
                 decode_fuse=1, paged: bool = True,
                 continuous: bool = True, collect_logits: bool = False,
                 pad_id: int = 0, decode_retries: int = 2,
                 fail_fast: bool = False,
                 slos: Optional[Sequence] = None,
                 drain_timeout_s: float = 30.0,
                 kv_dtype: Optional[str] = None,
                 prefix_cache_pages: int = 0,
                 speculation=None, spec_drafter: str = "ngram",
                 cuda_graphs: bool = True):
        if kv_dtype not in (None, "int8"):
            raise ValueError("kv_dtype must be None or 'int8', got %r"
                             % (kv_dtype,))
        if kv_dtype == "int8":
            raise NotImplementedError(
                "kv_dtype='int8' is not ported yet: the int8 KV pages engage "
                "only through a calibrated scale from monitor.numerics "
                "(ROADMAP.md Queue 1 item 8)")
        if slos:
            raise NotImplementedError(
                "slos are not ported yet: they are evaluated by monitor/'s "
                "SLO monitor on telemetry export ticks (monitor/slo, "
                "monitor/telemetry; ROADMAP.md Queue 1 item 8)")
        if max_seq % page_size != 0:
            raise ValueError("max_seq=%d must be a multiple of page_size=%d"
                             % (max_seq, page_size))
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.max_seq = int(max_seq)
        self.num_pages = (self.slots * (self.max_seq // self.page_size)
                          if num_pages is None else int(num_pages))
        self.prompt_buckets = tuple(sorted(
            prompt_buckets if prompt_buckets is not None
            else _pow2_buckets(min(8, max_seq), max_seq)))
        if self.prompt_buckets[-1] > self.max_seq:
            raise ValueError("prompt bucket %d exceeds max_seq %d"
                             % (self.prompt_buckets[-1], self.max_seq))
        self.max_queue = int(max_queue)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.decode_fuse_source = "explicit"
        if decode_fuse is None or decode_fuse == "auto":
            decode_fuse, self.decode_fuse_source = 1, "default"
        self.decode_fuse = max(1, int(decode_fuse))
        self.paged = bool(paged)
        self.continuous = bool(continuous)
        self.collect_logits = bool(collect_logits)
        self.pad_id = int(pad_id)
        self.decode_retries = max(0, int(decode_retries))
        self.fail_fast = bool(fail_fast)
        self.slos: list = []
        self.drain_timeout_s = float(drain_timeout_s)
        self.kv_dtype = kv_dtype
        self.prefix_cache_pages = max(0, int(prefix_cache_pages))
        if self.prefix_cache_pages >= self.num_pages:
            raise ValueError(
                "prefix_cache_pages=%d must leave serving pages free "
                "(num_pages=%d)" % (self.prefix_cache_pages, self.num_pages))
        self.spec_drafter = str(spec_drafter)
        if speculation is None:
            speculation = os.environ.get("PADDLE_TPU_SPECULATION") or None
        spec = _speculative.parse_speculation(speculation)
        if spec == "auto":
            spec, self.speculation_source = SPEC_AUTO_K, "default"
        else:
            self.speculation_source = "off" if not spec else "explicit"
        self.speculation = max(0, int(spec or 0))
        if self.speculation == 0:
            self.speculation_source = "off"
        self.cuda_graphs = bool(cuda_graphs)


class ServingEngine:
    """Drives a model implementing the serving contract:

    * ``model.cfg`` — exposes ``n_layer``/``n_head``/``d_head``/``max_seq``
      /``vocab_size``/``dtype`` (models.decoder_lm.DecoderConfig shape),
    * ``model.device`` — where its parameters live,
    * ``model.prefill(tokens[B,S], lengths[B]) -> (logits[B,S,V], kvs)``
      with ``kvs`` one ``(k, v)`` ``[B,S,H,D]`` pair per layer,
    * ``model.decode(cache, cache_ops, tokens[B], pos[B], active[B]) ->
      (logits[B,V], cache)``,
    * optionally ``model.verify(cache, cache_ops, tokens[B,W], pos[B],
      active[B], write_mask[B,W]) -> (logits[B,W,V], cache)``: without it
      speculation resolves off and a prefix-cache hit is not served.

    ``device=None`` means the card, and raises ``RuntimeError`` without
    one; the model must live on the same device.
    """

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 device=None):
        self.device = resolve_device(device)
        if torch.device(model.device) != self.device:
            raise ValueError("model lives on %s but the engine runs on %s"
                             % (model.device, self.device))
        self.model = model
        self.cfg = config or ServingConfig()
        mcfg = model.cfg
        if mcfg.max_seq < self.cfg.max_seq:
            raise ValueError(
                "model max_seq %d < serving max_seq %d (position table too "
                "small for the context budget)" % (mcfg.max_seq, self.cfg.max_seq))
        if self.cfg.paged:
            self.cache_ops = PagedKVCache(
                mcfg.n_layer, mcfg.n_head, mcfg.d_head, self.cfg.slots,
                self.cfg.max_seq, self.cfg.page_size, self.cfg.num_pages,
                dtype=mcfg.dtype, device=self.device)
            self.pool: Optional[PagePool] = PagePool(
                self.cfg.num_pages, self.cfg.page_size)
        else:
            self.cache_ops = ContiguousKVCache(
                mcfg.n_layer, mcfg.n_head, mcfg.d_head, self.cfg.slots,
                self.cfg.max_seq, dtype=mcfg.dtype, device=self.device)
            self.pool = None
        self.scheduler = Scheduler(self.cfg.slots, self.cfg.max_queue,
                                   continuous=self.cfg.continuous)
        self._cache = self.cache_ops.init_state()
        b = self.cfg.slots

        def vec(value, dtype):
            return torch.full((b,), value, dtype=dtype, device=self.device)

        # the slot state: static tensors, written in place and never
        # rebound (a captured dispatch reads these very tensors)
        self._len = vec(0, torch.int32)
        self._tok = vec(0, torch.int32)
        self._active = vec(False, torch.bool)
        self._gen = vec(0, torch.int32)
        self._maxnew = vec(1, torch.int32)
        self._temp = vec(0.0, torch.float32)
        self._topk = vec(0, torch.int32)
        self._seed = vec(0, torch.int32)
        # (kind, width, sampled) -> CapturedDispatch with its buffers
        self._dispatches: Dict[tuple, CapturedDispatch] = {}
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._spec_capable = hasattr(model, "verify")
        self._drafter = _speculative.make_drafter(self.cfg.spec_drafter)
        self._spec_k = np.zeros((b,), np.int32)  # per-slot resolved draft k
        self._spec_enabled = False  # any slot ever armed with k > 0
        self.prefix_cache = None
        if self.cfg.paged and self.cfg.prefix_cache_pages > 0:
            from ..fleet.prefix_cache import PrefixCache

            self.prefix_cache = PrefixCache(self.cfg.prefix_cache_pages,
                                            self.cfg.page_size)
        self._captured_logits: Dict[int, List[np.ndarray]] = {}
        self._consecutive_failures = 0
        self._faults_absorbed = 0
        self._last_error: Optional[str] = None
        self._closed = False
        self._draining = False
        self.last_drain: Optional[dict] = None
        # drain re-entrancy latch: a nested drain (signal handler firing
        # mid-drain) must observe, not re-enter
        self._drain_active = False
        self._drain_summary: Optional[dict] = None
        # per-ENGINE step accounting (the registry counters are shared
        # process-wide)
        self.prefills = 0
        self.resumes = 0
        self.decode_steps = 0
        self.dispatches = 0
        self.dispatch_host_s = 0.0  # launch side of every dispatch
        self.dispatch_s = 0.0       # whole dispatches, host sync included
        # ("prefill" | "resume", bucket) -> ms of each, its token read
        # included
        self.prompt_ms: Dict[tuple, List[float]] = {}

    # -- public API -----------------------------------------------------------
    def close(self) -> None:
        """Drop the engine's CUDA graphs and their memory pools. Idempotent;
        a later dispatch captures again."""
        if self._closed:
            return
        self._closed = True
        for d in self._dispatches.values():
            d.release()
        self._dispatches.clear()

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               deadline_s: Optional[float] = None,
               temperature: float = 0.0, top_k: int = 0,
               seed: Optional[int] = None,
               trace_id: Optional[str] = None, attempt: int = 0,
               speculation=None) -> Request:
        """Queue a request. Raises ``ValueError`` for a request that can
        NEVER be served at this geometry, ``BackpressureError`` when the
        bounded queue is full (shed/retry — transient) and
        ``DrainingError`` once the engine drains. ``deadline_s`` bounds the
        request's wall-clock life from submission: past it the request is
        retired with TIMEOUT status (queued or running). ``temperature``/
        ``top_k``/``seed`` select device-side sampled decoding for THIS
        request (see :class:`~.request.Request`); the default is exact
        greedy. ``speculation`` overrides the engine's speculative-decoding
        default for THIS request (``0`` off, int draft-k, ``"auto"``,
        ``None`` inherit) — the emitted stream is bit-identical either
        way."""
        if self._draining:
            _sm.DRAIN_REJECTED.inc()
            raise DrainingError(
                "engine is draining (graceful shutdown): not admitting new "
                "requests — re-route to a peer")
        req = Request(prompt, max_new_tokens, deadline_s=deadline_s,
                      temperature=temperature, top_k=top_k, seed=seed,
                      trace_id=trace_id, attempt=attempt,
                      speculation=speculation)
        if req.prompt_len > self.cfg.prompt_buckets[-1]:
            raise ValueError(
                "prompt length %d exceeds the largest prefill bucket %d"
                % (req.prompt_len, self.cfg.prompt_buckets[-1]))
        total = req.prompt_len + req.max_new_tokens
        if total > self.cfg.max_seq:
            raise ValueError(
                "prompt+max_new_tokens=%d exceeds max_seq=%d" %
                (total, self.cfg.max_seq))
        if self.pool is not None and \
                self.pool.pages_needed(total) > self.pool.num_pages:
            raise ValueError(
                "request needs %d pages but the pool only has %d"
                % (self.pool.pages_needed(total), self.pool.num_pages))
        return self.scheduler.submit(req)

    def step(self) -> List[Request]:
        """One multiplexer cycle: expire deadlines, admit into free slots,
        prefill the admissions, then one decode dispatch. Returns requests
        that reached a terminal state during the cycle (FINISHED, TIMEOUT
        or FAILED — check ``req.state``)."""
        finished = self._expire_deadlines()
        finished.extend(self._admit())
        if self.scheduler.occupancy:
            finished.extend(self._decode_dispatch())
        return finished

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drive :meth:`step` until queue and slots drain (or ``max_steps``).
        Updates the ``serving/tokens_per_sec`` gauge over the drive. A
        :meth:`request_drain` arriving mid-drive flips the loop into
        :meth:`drain`."""
        t0 = time.perf_counter()
        tok0 = _sm.TOKENS_GENERATED.value
        done: List[Request] = []
        steps = 0
        while not self.scheduler.idle():
            if self._draining:
                self.drain()
                break
            if max_steps is not None and steps >= max_steps:
                break
            done.extend(self.step())
            steps += 1
        dt = time.perf_counter() - t0
        if dt > 0:
            _sm.TOKENS_PER_SEC.set((_sm.TOKENS_GENERATED.value - tok0) / dt)
        return done

    def request_drain(self) -> None:
        """Signal-handler-safe drain request: new submissions start
        rejecting typed (:class:`~.request.DrainingError`) immediately;
        :meth:`run` performs the drain at the next cycle boundary."""
        self._draining = True

    def drain(self, timeout_s: Optional[float] = None) -> dict:
        """Graceful shutdown: stop admitting (queued requests are shed
        with terminal state REJECTED), FINISH the in-flight requests
        (bounded by ``timeout_s``; stragglers past it retire TIMEOUT with
        their pages reclaimed), return the prefix cache's pages, then
        :meth:`close`. Returns and stores (``engine.last_drain``) a
        summary dict. Idempotent and re-entrant, as the JAX package's."""
        if self.last_drain is not None:
            return self.last_drain
        if self._drain_active:
            return dict(self._drain_summary or {})
        self._drain_active = True
        summary = {"finished": 0, "timed_out": 0, "failed": 0,
                   "rejected": 0}
        self._drain_summary = summary
        try:
            if timeout_s is None:
                timeout_s = self.cfg.drain_timeout_s
            self._draining = True
            _sm.DRAINS.inc()
            now = time.perf_counter()
            for req in self.scheduler.drain_queue():
                req.finished_t = now
                summary["rejected"] += 1
            deadline = time.monotonic() + timeout_s
            while self.scheduler.occupancy and time.monotonic() < deadline:
                for req in self.step():
                    key = {FINISHED: "finished", TIMEOUT: "timed_out",
                           FAILED: "failed"}.get(req.state)
                    if key is not None:
                        summary[key] += 1
            for slot in range(self.cfg.slots):
                if self.scheduler.slot_request(slot) is not None:
                    self._retire(slot, state=TIMEOUT)
                    summary["timed_out"] += 1
            if self.prefix_cache is not None and self.pool is not None:
                # cached prefix pages are engine-lifetime pins: a drained
                # engine returns them so accounting ends at zero used
                self.pool.free(self.prefix_cache.flush())
            _sm.DRAINED_REQUESTS.inc(summary["finished"])
            self.last_drain = summary
            self.close()
            return summary
        finally:
            self._drain_active = False

    def captured_logits(self, req: Request) -> List[np.ndarray]:
        """Per-emitted-token logits rows (``collect_logits=True`` only)."""
        return self._captured_logits.get(req.id, [])

    def decode_kernel_info(self) -> tuple:
        """``(kernel, source)`` of the decode-attention inner loop as THIS
        engine resolves it: ``("paged", "cuda")`` when the ragged
        paged-attention CUDA kernel runs (``FLAGS_paged_attention_kernel``
        armed, paged layout, a CUDA device), else ``("gather", "n/a")`` —
        on the CPU the wrapper's plain version IS the gather path."""
        if self.cfg.paged and self.device.type == "cuda" \
                and attention_ops.paged_kernel_enabled():
            return "paged", "cuda"
        return "gather", "n/a"

    def speculation_info(self) -> tuple:
        """``(k, drafter_kind, source)`` of the engine-default speculation:
        ``k`` 0 = off (also when the model lacks ``verify``)."""
        if not self._spec_capable:
            return 0, "n/a", "off"
        k = self.cfg.speculation
        kind = self._drafter.kind if k > 0 else "off"
        return k, kind, self.cfg.speculation_source

    def graph_info(self) -> dict:
        """The engine's dispatch bodies: per ``kind/width/greedy|sampled``
        whether it is captured, its capture seconds, the reserved-memory
        growth over its capture (its graph pool) and its replays."""
        return {"%s/%d/%s" % (kind, w, "sampled" if s else "greedy"): {
                    "captured": d.graph is not None,
                    "capture_s": d.capture_s, "pool_bytes": d.pool_bytes,
                    "replays": d.replays}
                for (kind, w, s), d in self._dispatches.items()}

    def stats(self) -> dict:
        kern, kern_src = self.decode_kernel_info()
        spec_k, spec_kind, spec_src = self.speculation_info()
        out = {
            "layout": self.cache_ops.layout,
            "queued": self.scheduler.queue_depth,
            "running": self.scheduler.occupancy,
            "cache_bytes": self.cache_ops.cache_bytes(self._cache),
            "decode_fuse": self.cfg.decode_fuse,
            "decode_fuse_source": self.cfg.decode_fuse_source,
            "decode_kernel": kern,
            "decode_kernel_source": kern_src,
            "speculation": spec_k,
            "spec_drafter": spec_kind,
            "speculation_source": spec_src,
            "kv_layout": self.cache_ops.layout,
            "kv_dtype": str(self.cache_ops.dtype).replace("torch.", ""),
            "prefills": self.prefills,
            "resumes": self.resumes,
            "decode_steps": self.decode_steps,
            "cuda_graphs": sum(d.graph is not None
                               for d in self._dispatches.values()),
            "prompt_pool_bytes": sum(
                d.pool_bytes for (kind, _, _), d in self._dispatches.items()
                if kind in ("prefill", "resume")),
        }
        if self.pool is not None:
            out["pages_in_use"] = self.pool.num_used
            out["page_pool_utilization"] = round(self.pool.utilization, 4)
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        return out

    def health(self) -> dict:
        """Liveness/degradation snapshot: ``status`` is ``"ok"`` until a
        decode failure is absorbed and back to ``"ok"`` after the next
        clean dispatch (``"degraded"`` in between). Counters are lifetime
        totals for THIS engine. (The JAX package adds SLO keys only when
        SLOs are configured, which the port does not take yet.)"""
        out = {
            "status": "degraded" if self._consecutive_failures else "ok",
            "queued": self.scheduler.queue_depth,
            "running": self.scheduler.occupancy,
            "consecutive_failures": self._consecutive_failures,
            "faults_absorbed": self._faults_absorbed,
            "last_error": self._last_error,
            "page_accounting_ok": self.page_accounting_ok(),
            "prefills": self.prefills,
            "resumes": self.resumes,
        }
        if self.pool is not None:
            out["pages_free"] = self.pool.num_free
            out["pages_total"] = self.pool.num_pages
        return out

    def page_accounting_ok(self) -> bool:
        """The no-leak invariant every retirement path must preserve: pages
        the pool counts as used == pages held by running requests + pages
        owned by the prefix cache."""
        if self.pool is None:
            return True
        held = sum(len(r.pages) for r in self.scheduler.running())
        if self.prefix_cache is not None:
            held += self.prefix_cache.pages_held
        return self.pool.num_used == held

    # -- cross-engine page migration ------------------------------------------
    # The shippable unit of state is a prefix-cache entry: page-aligned
    # prompt KV pages + the exact tokens they cover. Export COPIES bytes;
    # import is atomic from the pool's point of view (any failure frees
    # the reservation first), so page_accounting_ok holds on both sides.
    def export_prefix_pages(self, tokens: Sequence[int]):
        """Serialize the prefix-cache entry exactly covering ``tokens`` to
        ``(meta, blobs)``; None when absent or without a prefix cache."""
        if self.prefix_cache is None:
            return None
        entry = self.prefix_cache.get(tokens)
        if entry is None:
            return None
        return self.cache_ops.export_pages(self._cache, entry.pages)

    def ingest_prefix_pages(self, tokens: Sequence[int], meta: dict,
                            blobs) -> bool:
        """Land an exported prefix (from this package or the JAX one) into
        THIS engine's pool + prefix cache. Returns False (never raises)
        when it cannot; every refusal frees the reservation first.
        Re-ingesting an already-held prefix is a no-op success."""
        if self.pool is None or self.prefix_cache is None or self._closed:
            return False
        tokens = [int(t) for t in tokens]
        n = int(meta.get("n_pages", 0))
        if n < 1 or len(tokens) != n * self.cfg.page_size:
            return False
        if self.prefix_cache.contains(tokens):
            return True
        try:
            pages = self.pool.alloc(n)
        except PagePoolExhausted:
            return False
        try:
            self.cache_ops.import_pages(self._cache, pages, meta, blobs)
        except ValueError:
            self.pool.free(pages)
            return False
        accepted, evicted = self.prefix_cache.insert(tokens, pages)
        if evicted:
            self.pool.free(evicted)
        if not accepted:
            self.pool.free(pages)
            return False
        return True

    def evict_prefix(self, tokens: Sequence[int]) -> int:
        """Drop one prefix entry and free its pages; returns pages freed."""
        if self.pool is None or self.prefix_cache is None:
            return 0
        pages = self.prefix_cache.evict(tokens)
        if pages:
            self.pool.free(pages)
        return len(pages)

    def export_request_prefix(self, req: Request):
        """Copy a live request's page-aligned PROMPT prefix as ``(tokens,
        meta, blobs)``; None when there is less than one full page or no
        paged pool."""
        if self.pool is None or not req.pages:
            return None
        ps = self.cfg.page_size
        n_tok = ((req.prompt_len - 1) // ps) * ps
        npages = n_tok // ps
        if npages < 1 or len(req.pages) < npages:
            return None
        meta, blobs = self.cache_ops.export_pages(
            self._cache, req.pages[:npages])
        return [int(t) for t in req.prompt[:n_tok]], meta, blobs

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Warm each prefill bucket up (the given ones, default all:
        first-use costs such as cuBLAS handles and the allocator's blocks
        are paid here, not by the first requests) and, on the card,
        capture its graph, and with a prefix cache armed the resume's at
        each bucket; capture the decode dispatch at ``decode_fuse`` and,
        with speculation on, the verify window at ``speculation + 1``,
        greedy and sampled. Needs an idle engine: the bodies run on it
        with a prompt of length 0 (every KV write goes to the sink row)
        and every slot inactive, which changes no state a request reads
        (slot 0's page-table row is rewritten before its next use)."""
        if self.scheduler.occupancy:
            raise RuntimeError("warmup() needs an idle engine; %d slots "
                               "are running" % self.scheduler.occupancy)
        dev = self.device
        kinds = ["prefill"]
        if self.prefix_cache is not None and self._spec_capable:
            kinds.append("resume")
        for b in (buckets or self.cfg.prompt_buckets):
            for kind in kinds:
                d = self._prompt_dispatch(kind, self._bucket_for(b))
                d.inputs[0].zero_()
                d.inputs[1].copy_(d.inputs[0])
                d.run()
                while d.capture and d.graph is None:
                    d.run()
        if dev.type != "cuda" or not self.cfg.cuda_graphs:
            return
        keys = [("decode", self.cfg.decode_fuse)]
        if self._spec_capable and self.cfg.speculation > 0:
            keys.append(("verify", self.cfg.speculation + 1))
        for kind, w in keys:
            for sampled in (False, True):
                d = self._dispatch(kind, w, sampled)
                while d.graph is None:
                    d.run()
        torch.cuda.synchronize(dev)

    # -- admission + prefill --------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.cfg.prompt_buckets:
            if n <= b:
                return b
        raise ValueError("no prefill bucket covers prompt length %d" % n)

    def _admit(self) -> List[Request]:
        finished: List[Request] = []
        slots = self.scheduler.admissible_slots()
        if not slots or self.scheduler.peek() is None:
            return finished
        wave_bucket = None
        if not self.cfg.continuous:
            # the padded static baseline: every prompt of the wave pays the
            # wave-max bucket, the classic fully-padded batch
            wave = self.scheduler.peek_n(len(slots))
            wave_bucket = self._bucket_for(max(r.prompt_len for r in wave))
        for slot in slots:
            req = self.scheduler.peek()
            if req is None:
                break
            pages: List[int] = []
            if self.pool is not None:
                need = self.pool.pages_needed(
                    req.prompt_len + req.max_new_tokens)
                try:
                    pages = self.pool.alloc(need)
                except PagePoolExhausted:
                    # graceful backpressure: the request stays at the queue
                    # head; retirements will free pages
                    self.scheduler.requeue_head_blocked()
                    break
            req = self.scheduler.admit(slot)
            req.admitted_t = time.perf_counter()
            req.pages = pages
            bucket = wave_bucket or self._bucket_for(req.prompt_len)
            done = self._prefill(req, slot, bucket)
            if done is not None:
                finished.append(done)
        return finished

    def _prompt_dispatch(self, kind: str, bucket: int) -> CapturedDispatch:
        """The ``prefill`` or ``resume`` dispatch at ``bucket``, with its
        buffers: ``inputs`` (a host int32 staging vector, pinned on the
        card, and its static copy on the device; layout in
        :meth:`_prompt_inputs`), ``out`` (the first token, int32 [1]) and
        ``logits`` (its logits row)."""
        key = (kind, bucket, True)
        d = self._dispatches.get(key)
        if d is None:
            dev = self.device
            width = self.cache_ops.pages_per_slot if self.cfg.paged else 1
            n = bucket + 6 + width
            host = torch.zeros((n,), dtype=torch.int32)
            if dev.type == "cuda":
                host = host.pin_memory()
            ins = torch.zeros((n,), dtype=torch.int32, device=dev)
            out = torch.zeros((1,), dtype=torch.int32, device=dev)
            last = torch.zeros((self.model.cfg.vocab_size,),
                               dtype=self.model.cfg.dtype, device=dev)
            body = (self._prefill_body if kind == "prefill"
                    else self._resume_body)(bucket, ins, out, last)
            d = CapturedDispatch("%s(bucket=%d)" % (kind, bucket), body, dev,
                                 self._stream, capture=self.cfg.cuda_graphs)
            d.out, d.logits, d.inputs = out, last, (host, ins)
            self._dispatches[key] = d
        return d

    @staticmethod
    def _prompt_inputs(ins, bucket):
        """The views of a prompt dispatch's static int32 inputs: the
        tokens [1, bucket], then [1] each of the length (the prompt's, or
        the prefix's on a resume), the remainder's length (a resume's),
        the slot, top-k, the seed and the temperature's float32 bits, then
        the slot's page-table row (the slot itself in the contiguous
        layout)."""
        b = bucket
        return (ins[:b].view(1, b), ins[b:b + 1], ins[b + 1:b + 2],
                ins[b + 2:b + 3], ins[b + 3:b + 4], ins[b + 4:b + 5],
                ins[b + 5:b + 6].view(torch.float32), ins[b + 6:])

    def _stage(self, d, bucket, tokens, length, rem, slot, req, dest):
        """Fill a prompt dispatch's host staging vector and copy it to the
        device in one transfer."""
        host, ins = d.inputs
        hv = host.numpy()
        hv[:] = 0
        hv[:bucket] = self.cfg.pad_id
        hv[:len(tokens)] = tokens
        hv[bucket:bucket + 5] = (length, rem, slot, req.top_k, req.seed)
        hv[bucket + 5:bucket + 6].view(np.float32)[0] = req.temperature
        hv[bucket + 6:bucket + 6 + len(dest)] = dest
        ins.copy_(host, non_blocking=True)

    def _prefill_body(self, bucket, ins, out, last_out):
        """The prefill at ``bucket`` on static inputs: the slot's
        page-table row set, ``model.prefill``, each layer's prompt KV
        written below the length (the rest to the sink row), and the first
        token picked from the logits row at ``length - 1``, keyed by that
        position (decode then keys length, length+1, ...)."""
        cfg, model, ops = self.cfg, self.model, self.cache_ops
        toks, length, _, slot, top_k, seed, temp, dest = \
            self._prompt_inputs(ins, bucket)

        def body():
            with torch.no_grad():
                if cfg.paged:
                    self._cache["pt"].index_copy_(0, slot.long(), dest[None])
                logits, kvs = model.prefill(toks, length)
                for i, (k, v) in enumerate(kvs):
                    ops.write_prompt(self._cache, i, k[0], v[0],
                                     dest if cfg.paged else slot, length[0])
                pos = length - 1
                last = logits[0].index_select(0, pos.clamp_min(0).long())
                out.copy_(_sample_tokens(last, temp, top_k, seed, pos))
                last_out.copy_(last[0])

        return body

    def _resume_body(self, bucket, ins, out, last_out):
        """The prefix-hit resume at ``bucket`` on static inputs: the slot's
        page-table row set, then the prompt's remainder (``rem`` tokens
        from position ``length``, the prefix's) through the model's verify
        window for this one slot, padded to ``bucket`` with the writes past
        the remainder masked (the JAX package scans ``model.decode`` over
        the remainder bucket: the same positions, K/V written before
        attention); the first token is keyed (seed, prompt length - 1), as
        the cold prefill keys it."""
        model, ops, dev = self.model, self.cache_ops, self.device
        toks, length, rem, slot, top_k, seed, temp, row = \
            self._prompt_inputs(ins, bucket)

        def body():
            with torch.no_grad():
                self._cache["pt"].index_copy_(0, slot.long(), row[None])
                one = {"k": self._cache["k"], "v": self._cache["v"],
                       "pt": row[None]}
                j = torch.arange(bucket, dtype=torch.int32, device=dev)
                logits, _ = model.verify(
                    one, ops, toks, length,
                    torch.ones(1, dtype=torch.bool, device=dev),
                    (j < rem)[None])
                last = logits[0].index_select(
                    0, (rem - 1).clamp_min(0).long())
                out.copy_(_sample_tokens(last, temp, top_k, seed,
                                         length + rem - 1))
                last_out.copy_(last[0])

        return body

    def _prefill(self, req: Request, slot: int, bucket: int
                 ) -> Optional[Request]:
        """Prefill one admitted request at its bucket width through the
        bucket's dispatch (a graph replay on the card), read its first
        token; returns the request if it finished at once. With a prefix
        cache armed, a prompt whose page-aligned prefix is cached skips
        the full prefill (:meth:`_prefill_from_prefix`)."""
        if self.prefix_cache is not None and self._spec_capable:
            entry = self.prefix_cache.lookup(req.prompt)
            if entry is not None:
                return self._prefill_from_prefix(req, slot, entry)
        t0 = time.perf_counter()
        d = self._prompt_dispatch("prefill", bucket)
        dest = (self.cache_ops.prompt_dest(req.pages) if self.cfg.paged
                else [slot])
        self._stage(d, bucket, req.prompt, req.prompt_len, 0, slot, req,
                    dest)
        d.run()
        tok = int(d.out[0])  # the prefill's one host sync
        ms = (time.perf_counter() - t0) * 1e3
        _sm.PREFILL_MS.observe(ms)
        _sm.PREFILL_COUNT.inc()
        self.prompt_ms.setdefault(("prefill", bucket), []).append(ms)
        self.prefills += 1
        return self._finish_prefill(req, slot, tok, d.logits)

    def _prefill_from_prefix(self, req: Request, slot: int, entry
                             ) -> Optional[Request]:
        """Serve admission from a prefix-cache hit: row-copy the cached
        prefix KV into the request's pages, then run ONLY the prompt
        remainder through the resume dispatch at its bucket, so hit and
        miss generate the same stream."""
        ps, dev = self.cfg.page_size, self.device
        n = entry.n_tokens
        npages = len(entry.pages)
        rows = np.arange(ps, dtype=np.int64)
        src = torch.as_tensor(
            np.concatenate([p * ps + rows for p in entry.pages]), device=dev)
        dst = torch.as_tensor(
            np.concatenate([p * ps + rows for p in req.pages[:npages]]),
            device=dev)
        t0 = time.perf_counter()
        for name in ("k", "v"):
            self._cache[name][:, dst] = self._cache[name][:, src]
        rem = req.prompt_len - n
        bucket = self._bucket_for(rem)
        d = self._prompt_dispatch("resume", bucket)
        self._stage(d, bucket, req.prompt[n:], n, rem, slot, req,
                    self.cache_ops.prompt_dest(req.pages))
        d.run()
        tok = int(d.out[0])
        ms = (time.perf_counter() - t0) * 1e3
        _sm.PREFILL_MS.observe(ms)
        # deliberately NOT PREFILL_COUNT: "fewer prefills than cold" reads it
        self.prompt_ms.setdefault(("resume", bucket), []).append(ms)
        self.resumes += 1
        return self._finish_prefill(req, slot, tok, d.logits)

    def _finish_prefill(self, req: Request, slot: int, tok: int,
                        last_logits) -> Optional[Request]:
        """Post-prefill bookkeeping shared by the cold and prefix-hit
        paths: TTFT, first token, immediate retirement, slot arming."""
        cfg = self.cfg
        _sm.TOKENS_GENERATED.inc()
        now = time.perf_counter()
        req.first_token_t = now
        _sm.TTFT_MS.observe((now - req.submitted_t) * 1e3)
        req.tokens_out.append(tok)
        if cfg.collect_logits:
            # copied: the row is the dispatch's static buffer
            self._captured_logits.setdefault(req.id, []).append(
                last_logits.float().cpu().numpy().copy())
        if (cfg.eos_id is not None and tok == cfg.eos_id) \
                or req.max_new_tokens == 1:
            return self._retire(slot)
        self._len[slot] = req.prompt_len
        self._tok[slot] = tok
        self._active[slot] = True
        self._gen[slot] = 1
        self._maxnew[slot] = req.max_new_tokens
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._seed[slot] = req.seed
        k = self._request_spec_k(req)
        self._spec_k[slot] = k
        if k > 0:
            self._spec_enabled = True
        return None

    # -- decode ---------------------------------------------------------------
    def _request_spec_k(self, req: Request) -> int:
        """The draft k THIS request decodes with: per-request override >
        engine default; 0 when the model lacks the verify contract."""
        if not self._spec_capable:
            return 0
        s = req.speculation
        if s is None:
            return self.cfg.speculation
        if s == "auto":
            return SPEC_AUTO_K
        return min(max(0, int(s)), _speculative.SPEC_K_CAP)

    def _build_drafts(self):
        """Host-side draft pass over the in-flight batch: ask the drafter
        for up to k proposals per speculative slot (its full prompt +
        generated history), capped at the slot's remaining emit budget.
        Returns ``(draft [B,kmax], dlen [B], width)`` or None when no slot
        proposed anything (the tick then takes the plain decode path)."""
        if not self._spec_enabled:
            return None
        b = self.cfg.slots
        props: Dict[int, List[int]] = {}
        kmax = 0
        for slot in range(b):
            req = self.scheduler.slot_request(slot)
            if req is None:
                continue
            k = int(self._spec_k[slot])
            if k <= 0:
                continue
            gen = len(req.tokens_out)
            ln = req.prompt_len + gen - 1
            k = min(k, req.max_new_tokens - gen, self.cfg.max_seq - ln - 1)
            if k <= 0:
                continue
            prop = self._drafter.propose(
                list(req.prompt) + req.tokens_out, k)
            if prop:
                props[slot] = prop
                kmax = max(kmax, len(prop))
        if kmax == 0:
            return None
        draft = np.zeros((b, kmax), np.int32)
        dlen = np.zeros((b,), np.int32)
        for slot, prop in props.items():
            draft[slot, :len(prop)] = prop
            dlen[slot] = len(prop)
        return draft, dlen, kmax + 1

    def _sampling(self) -> bool:
        """Whether an admitted request samples: greedy-only batches replay
        the bodies without the sampler's sort and draw (the tokens are the
        same: the sampler selects ``argmax`` at temperature 0)."""
        return any(r.temperature > 0 for r in self.scheduler.running())

    def _dispatch(self, kind: str, width: int, sampled: bool
                  ) -> CapturedDispatch:
        key = (kind, width, sampled)
        d = self._dispatches.get(key)
        if d is None:
            b, dev = self.cfg.slots, self.device
            out = torch.zeros((3, width, b), dtype=torch.int32, device=dev)
            logits = (torch.zeros((width, b, self.model.cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
                      if self.cfg.collect_logits else None)
            if kind == "decode":
                body = self._decode_body(width, sampled, out, logits)
                ins = None
            else:
                ins = (torch.zeros((b, width - 1), dtype=torch.int32,
                                   device=dev),
                       torch.zeros((b,), dtype=torch.int32, device=dev))
                body = self._verify_body(width, sampled, out, logits, *ins)
            d = CapturedDispatch("%s(width=%d, %s)" % (
                kind, width, "sampled" if sampled else "greedy"), body, dev,
                self._stream, capture=self.cfg.cuda_graphs)
            d.out, d.logits, d.inputs = out, logits, ins
            self._dispatches[key] = d
        return d

    def _pick(self, logits, sampled, position):
        if not sampled:
            return _greedy_tokens(logits)
        return _sample_tokens(logits, self._temp, self._topk, self._seed,
                              position)

    def _decode_body(self, steps, sampled, out, logits_out):
        """``steps`` decode steps over every slot, on the static state:
        each step writes the consumed token's KV, picks the next token
        (keyed by the consumed token's position ``ln``, which advances per
        STEP, so fuse 1 and fuse 4 draw the same stream), and advances
        length/generated counts of the active slots; a slot finishes on
        EOS, on ``max_new_tokens`` or at ``max_seq``. Writes the emitted
        tokens, emitted and finish flags into ``out`` [3, steps, B]."""
        cfg, model, ops = self.cfg, self.model, self.cache_ops
        eos = -1 if cfg.eos_id is None else cfg.eos_id

        def body():
            with torch.no_grad():
                ln, tk, ac, gc = self._len, self._tok, self._active, self._gen
                for f in range(steps):
                    logits, _ = model.decode(self._cache, ops, tk, ln, ac)
                    nxt = torch.where(ac, self._pick(logits, sampled, ln), tk)
                    out[1, f].copy_(ac)
                    gc = gc + ac
                    ln = ln + ac
                    fin = ac & ((nxt == eos) | (gc >= self._maxnew)
                                | (ln >= cfg.max_seq))
                    ac = ac & ~fin
                    tk = nxt
                    out[0, f].copy_(nxt)
                    out[2, f].copy_(fin)
                    if logits_out is not None:
                        logits_out[f].copy_(logits)
                self._len.copy_(ln)
                self._tok.copy_(tk)
                self._active.copy_(ac)
                self._gen.copy_(gc)

        return body

    def _verify_body(self, w, sampled, out, logits_out, draft, dlen):
        """The speculative draft-verify dispatch at window width ``w``
        (k+1). One windowed model forward scores every slot's window —
        position 0 its pending token, positions 1..k its draft (``draft``
        [B, w-1], ``dlen`` [B]) — then the plain decode body's EXACT
        per-step state machine runs over the window's target draws: step
        j emits the sampler's token at ``position=len+j``, advances
        len/gen, applies the same eos/max_new/max_ctx finish, and
        continues only while the NEXT consumed token (the draft) equals
        this step's emitted one. Equality-accept against the target's own
        position-keyed draw is exact speculative sampling for a
        deterministic drafter, so greedy and sampled streams are
        bit-identical to plain decode. A rejected tail never advances
        ``len``: its KV rows lie beyond every later read until
        overwritten. Window writes past the slot's reservation are masked
        (``write_mask``): those page-table entries are parked on page 0.
        ``out`` [3, w, B] as the decode body's."""
        cfg, model, ops = self.cfg, self.model, self.cache_ops
        eos = -1 if cfg.eos_id is None else cfg.eos_id
        b, dev = cfg.slots, self.device

        def body():
            with torch.no_grad():
                ln, tk, ac, gc = self._len, self._tok, self._active, self._gen
                steps = torch.arange(w, dtype=torch.int32, device=dev)
                cons = torch.cat([tk[:, None], draft], dim=1)
                posw = ln[:, None] + steps[None, :]
                write_mask = (ac[:, None]
                              & (gc[:, None] + steps[None, :]
                                 < self._maxnew[:, None])
                              & (posw < cfg.max_seq))
                logits, _ = model.verify(self._cache, ops, cons, ln, ac,
                                         write_mask)
                flat = logits.reshape(b * w, -1)
                if sampled:
                    def rep(t):
                        return t[:, None].expand(b, w).reshape(b * w)

                    tt = _sample_tokens(flat, rep(self._temp),
                                        rep(self._topk), rep(self._seed),
                                        posw.reshape(b * w))
                else:
                    tt = _greedy_tokens(flat)
                tt = tt.reshape(b, w)
                nxt_cons = torch.cat(
                    [draft, torch.zeros((b, 1), dtype=torch.int32,
                                        device=dev)], dim=1)
                sp = torch.ones((b,), dtype=torch.bool, device=dev)
                for j in range(w):
                    run = ac & sp
                    nxt = torch.where(run, tt[:, j], tk)
                    out[1, j].copy_(run)
                    gc = gc + run
                    ln = ln + run
                    fin = run & ((nxt == eos) | (gc >= self._maxnew)
                                 | (ln >= cfg.max_seq))
                    ac = ac & ~fin
                    sp = sp & (j < dlen) & (nxt == nxt_cons[:, j]) & ~fin
                    tk = nxt
                    out[0, j].copy_(nxt)
                    out[2, j].copy_(fin)
                    if logits_out is not None:
                        logits_out[j].copy_(logits[:, j])
                self._len.copy_(ln)
                self._tok.copy_(tk)
                self._active.copy_(ac)
                self._gen.copy_(gc)

        return body

    def _decode_dispatch(self) -> List[Request]:
        """One decode (or verify) dispatch with the recovery ladder:
        transient failures retry in place (bounded by ``decode_retries``);
        a failure that exhausts the budget — or classifies fatal — FAILS
        the in-flight batch (pages reclaimed, requests marked FAILED,
        device slot state reset) and the engine keeps serving the queue.

        The cache is written in place, so no failure can lose it; the
        rollback snapshot is a clone of the slot-state vectors the body
        writes. A failed step's KV rows lie at or beyond the restored
        ``len``, where no later read sees them until they are overwritten
        (the speculative rollback's argument)."""
        cfg = self.cfg
        t0 = time.perf_counter()
        sampled = self._sampling()
        drafts = self._build_drafts()
        if drafts is not None:
            draft_np, dlen_np, steps = drafts
            d = self._dispatch("verify", steps, sampled)
            d.inputs[0].copy_(torch.from_numpy(draft_np))
            d.inputs[1].copy_(torch.from_numpy(dlen_np))
        else:
            dlen_np = None
            steps = cfg.decode_fuse
            d = self._dispatch("decode", steps, sampled)
        state = (self._len, self._tok, self._active, self._gen)
        snap = [t.clone() for t in state]
        attempt = 0
        while True:
            try:
                spec = _faults.fire("serving.decode")  # chaos drills
                if spec is not None and spec.kind == "exhausted":
                    raise PagePoolExhausted(
                        "injected pool exhaustion at serving.decode")
                d.run()
                t_host = time.perf_counter()
                # one host sync per dispatch: the retire/admit decision
                # needs the emitted tokens (copied: on the CPU .cpu()
                # would hand back the static buffer itself)
                toks, emitted, fin = d.out.cpu().numpy().copy()
                logseq = (d.logits.cpu().numpy().copy()
                          if d.logits is not None else None)
                break
            except CaptureError:
                raise
            except Exception as e:
                for t, s in zip(state, snap):
                    t.copy_(s)
                if (_faults.classify(e) == "transient"
                        and attempt < cfg.decode_retries):
                    attempt += 1
                    _sm.RETRIES.inc()
                    continue
                if cfg.fail_fast:
                    raise
                return self._fail_inflight_batch(e)
        self._consecutive_failures = 0
        t1 = time.perf_counter()
        self.dispatches += 1
        self.dispatch_host_s += t_host - t0
        self.dispatch_s += t1 - t0
        _sm.DECODE_STEP_MS.observe((t1 - t0) * 1e3)
        _sm.DECODE_DISPATCHES.inc()
        # a verify dispatch is ONE windowed model step however wide the
        # window — tokens/steps > 1 is exactly the speculative win
        n_steps = 1 if dlen_np is not None else steps
        _sm.DECODE_STEPS.inc(n_steps)
        self.decode_steps += n_steps
        _sm.TOKENS_GENERATED.inc(int(emitted.sum()))
        if dlen_np is not None:
            # accepted drafts per slot = its run-steps beyond the first
            runs = emitted.sum(axis=0)
            proposed = int(dlen_np.sum())
            accepted = int(np.maximum(runs - 1, 0).sum())
            _sm.SPEC_PROPOSED.inc(proposed)
            _sm.SPEC_ACCEPTED.inc(accepted)
            _sm.SPEC_REJECTED.inc(proposed - accepted)
            _sm.SPEC_DRAFTS.inc(int((dlen_np > 0).sum()))
            _sm.SPEC_VERIFY_DISPATCHES.inc()
            _sm.SPEC_ACCEPT_RATE.observe(accepted / max(1, proposed))
        finished: List[Request] = []
        for slot in range(cfg.slots):
            req = self.scheduler.slot_request(slot)
            if req is None:
                continue
            for f in range(steps):
                if emitted[f, slot]:
                    req.tokens_out.append(int(toks[f, slot]))
                    if logseq is not None:
                        self._captured_logits.setdefault(req.id, []).append(
                            logseq[f, slot])
                if fin[f, slot]:
                    finished.append(self._retire(slot))
                    break
        return finished

    def _retire(self, slot: int, state: str = FINISHED,
                clear_slot: bool = True) -> Request:
        """EVERY slot-vacating path funnels through here — EOS/max_new
        (FINISHED), deadline (TIMEOUT), decode failure (FAILED) — so page
        reclamation can't be forgotten on a new path. ``clear_slot=False``
        is for callers about to reset ALL device slot state wholesale."""
        req = self.scheduler.retire(slot, state)
        if self.pool is not None and req.pages:
            donated = 0
            if self.prefix_cache is not None:
                donated = self._donate_prefix_pages(req, state)
            if donated < len(req.pages):
                self.pool.free(req.pages[donated:])
            req.pages = []
        req.finished_t = time.perf_counter()
        if state == FINISHED:
            _sm.REQUEST_LATENCY_MS.observe(
                (req.finished_t - req.submitted_t) * 1e3)
        elif state == TIMEOUT:
            _sm.TIMEOUTS.inc()
        elif state == FAILED:
            _sm.REQUESTS_FAILED.inc()
        if state != FINISHED and clear_slot:
            # the decode body only deactivates slots it finished itself;
            # an out-of-band retirement must clear the device-side flag or
            # the next dispatch decodes a ghost
            self._active[slot] = False
        return req

    def _donate_prefix_pages(self, req: Request, state: str) -> int:
        """Zero-copy prefix-cache insert at retirement: a FINISHED
        request's leading full-prompt pages transfer ownership to the
        cache instead of returning to the pool. Returns how many of
        ``req.pages`` the cache now owns (a prefix of the list). A request
        that did NOT finish never donates."""
        cache = self.prefix_cache
        n = cache.cacheable_len(req.prompt_len)
        if n <= 0:
            return 0
        if state != FINISHED:
            from ..fleet import metrics as _fm

            _fm.PREFIX_POISONED_SKIPPED.inc()
            return 0
        tokens = req.prompt[:n]
        if cache.contains(tokens):
            return 0
        npages = n // self.cfg.page_size
        accepted, evicted = cache.insert(tokens, req.pages[:npages])
        if evicted:
            self.pool.free(evicted)
        return npages if accepted else 0

    def _expire_deadlines(self) -> List[Request]:
        """Retire requests past their deadline — queued ones leave the
        queue (no pages to reclaim), running ones vacate slot + pages."""
        now = time.perf_counter()
        out: List[Request] = []
        for req in self.scheduler.drop_expired(now):
            req.finished_t = now
            _sm.TIMEOUTS.inc()
            out.append(req)
        for slot in range(self.cfg.slots):
            req = self.scheduler.slot_request(slot)
            if req is not None and req.expired(now):
                out.append(self._retire(slot, state=TIMEOUT))
        return out

    def _fail_inflight_batch(self, exc: BaseException) -> List[Request]:
        """Decode-failure recovery: mark every in-flight request FAILED,
        reclaim its pages, reset the device slot state IN PLACE (a
        captured dispatch reads these tensors), and leave the engine
        serving. The cache was written in place, so nothing of it is
        lost, and the prefix cache's pages stay valid."""
        self._consecutive_failures += 1
        self._faults_absorbed += 1
        self._last_error = "%s: %s" % (type(exc).__name__, exc)
        _sm.FAULTS.inc()
        failed: List[Request] = []
        for slot in range(self.cfg.slots):
            req = self.scheduler.slot_request(slot)
            if req is None:
                continue
            req.error = self._last_error
            failed.append(self._retire(slot, state=FAILED,
                                       clear_slot=False))
        for t in (self._len, self._tok, self._active, self._gen, self._temp,
                  self._topk, self._seed):
            t.zero_()
        self._maxnew.fill_(1)
        return failed
