# ported from paddle_tpu/serving/engine.py
"""Autoregressive decode driver: continuous batching over a paged KV-cache.

One :class:`ServingEngine` owns:

* a :class:`~.scheduler.Scheduler` (bounded queue → fixed batch slots,
  continuous in-flight admission or the static wave-drain baseline),
* a :class:`~.page_pool.PagePool` + :class:`~.kv_cache.PagedKVCache` (or
  the :class:`~.kv_cache.ContiguousKVCache` reference layout),
* the step functions: ONE prefill per admitted request, padded to a
  power-of-two prompt bucket as in the JAX package, and a decode dispatch
  of ``decode_fuse`` steps whose state (KV pages, page tables, slot
  occupancy, lengths) stays on the device between steps. Where the JAX
  package compiles the fused steps into one ``lax.scan``, PyTorch runs
  eagerly and the dispatch is a Python loop; it syncs with the host once,
  at its end, where the retire/admit decisions need the emitted tokens.

Decoding is greedy (``argmax``, first maximum on ties). Sampled decoding,
speculation, the prefix cache, drain, deadlines, fault retries, traces,
telemetry and SLOs are not ported yet (ROADMAP.md, Queue 1 item 5).
Observability is the ``serving/*`` counters and latency histograms
(serving.metrics).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.place import resolve_device
from ..ops import attention_ops
from . import metrics as _sm
from .kv_cache import ContiguousKVCache, PagedKVCache
from .page_pool import PagePool, PagePoolExhausted
from .request import FINISHED, Request
from .scheduler import Scheduler

__all__ = ["ServingConfig", "ServingEngine"]


def _pow2_buckets(lo: int, hi: int) -> tuple:
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(sorted(set(out)))


def _sample_tokens(logits) -> torch.Tensor:
    """Greedy per-slot token selection over ``logits`` [B,V]: ``argmax``,
    which returns the FIRST maximum on ties, as ``jnp.argmax`` does."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


class ServingConfig:
    """Engine geometry + policy knobs.

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
    """

    def __init__(self, slots: int = 8, page_size: int = 16,
                 max_seq: int = 128, num_pages: Optional[int] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 max_queue: int = 1024, eos_id: Optional[int] = None,
                 decode_fuse=1, paged: bool = True,
                 continuous: bool = True, collect_logits: bool = False,
                 pad_id: int = 0):
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


class ServingEngine:
    """Drives a model implementing the serving contract:

    * ``model.cfg`` — exposes ``n_layer``/``n_head``/``d_head``/``max_seq``
      /``dtype`` (models.decoder_lm.DecoderConfig shape),
    * ``model.device`` — where its parameters live,
    * ``model.prefill(tokens[B,S], lengths[B]) -> (logits[B,S,V], kvs)``
      with ``kvs`` one ``(k, v)`` ``[B,S,H,D]`` pair per layer,
    * ``model.decode(cache, cache_ops, tokens[B], pos[B], active[B]) ->
      (logits[B,V], cache)``.

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

        self._len = vec(0, torch.int32)
        self._tok = vec(0, torch.int32)
        self._active = vec(False, torch.bool)
        self._gen = vec(0, torch.int32)
        self._maxnew = vec(1, torch.int32)
        self._captured_logits: Dict[int, List[np.ndarray]] = {}
        # per-ENGINE step accounting (the registry counters are shared
        # process-wide)
        self.prefills = 0
        self.decode_steps = 0

    # -- public API -----------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               temperature: float = 0.0) -> Request:
        """Queue a greedy request. Raises ``ValueError`` for a request that
        can NEVER be served at this geometry, ``BackpressureError`` when the
        bounded queue is full (shed/retry — transient), and
        ``NotImplementedError`` for ``temperature > 0``: sampled decoding
        waits for a bit-exact threefry port (ROADMAP.md, Queue 1 item 5),
        without which the JAX package's sampled streams cannot be
        matched."""
        if temperature > 0:
            raise NotImplementedError(
                "sampled decoding (temperature > 0) is not ported yet: it "
                "needs the bit-exact threefry sampler of ROADMAP.md Queue 1 "
                "item 5 to match the JAX package's streams; submit greedy "
                "requests (temperature=0)")
        req = Request(prompt, max_new_tokens, temperature=temperature)
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
        """One multiplexer cycle: admit into free slots, prefill the
        admissions, then one decode dispatch. Returns the requests that
        FINISHED during the cycle."""
        finished = self._admit()
        if self.scheduler.occupancy:
            finished.extend(self._decode_dispatch())
        return finished

    def run(self) -> List[Request]:
        """Drive :meth:`step` until queue and slots drain. Updates the
        ``serving/tokens_per_sec`` gauge over the drive."""
        t0 = time.perf_counter()
        tok0 = _sm.TOKENS_GENERATED.value
        done: List[Request] = []
        while not self.scheduler.idle():
            done.extend(self.step())
        dt = time.perf_counter() - t0
        if dt > 0:
            _sm.TOKENS_PER_SEC.set((_sm.TOKENS_GENERATED.value - tok0) / dt)
        return done

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

    def stats(self) -> dict:
        kern, kern_src = self.decode_kernel_info()
        out = {
            "layout": self.cache_ops.layout,
            "queued": self.scheduler.queue_depth,
            "running": self.scheduler.occupancy,
            "cache_bytes": self.cache_ops.cache_bytes(self._cache),
            "decode_fuse": self.cfg.decode_fuse,
            "decode_fuse_source": self.cfg.decode_fuse_source,
            "decode_kernel": kern,
            "decode_kernel_source": kern_src,
            "prefills": self.prefills,
            "decode_steps": self.decode_steps,
        }
        if self.pool is not None:
            out["pages_in_use"] = self.pool.num_used
            out["page_pool_utilization"] = round(self.pool.utilization, 4)
        return out

    def page_accounting_ok(self) -> bool:
        """The no-leak invariant every retirement must preserve: pages the
        pool counts as used == pages held by running requests."""
        if self.pool is None:
            return True
        held = sum(len(r.pages) for r in self.scheduler.running())
        return self.pool.num_used == held

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

    def _prefill(self, req: Request, slot: int, bucket: int
                 ) -> Optional[Request]:
        """Prefill one admitted request at its bucket width, write its KV
        into the cache and pick its first token; returns the request if it
        finished at once (EOS first token / max_new_tokens == 1)."""
        cfg, dev, n = self.cfg, self.device, req.prompt_len
        prompt = np.full((1, bucket), cfg.pad_id, np.int32)
        prompt[0, :n] = req.prompt
        t0 = time.perf_counter()
        if cfg.paged:
            dest = torch.as_tensor(self.cache_ops.prompt_dest(req.pages),
                                   device=dev)
            self._cache["pt"][slot] = dest
        else:
            dest = self.cache_ops.prompt_dest(slot)
        logits, kvs = self.model.prefill(
            torch.as_tensor(prompt, device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev))
        for i, (k, v) in enumerate(kvs):
            self.cache_ops.write_prompt(self._cache, i, k[0], v[0], dest, n)
        last = logits[0, n - 1]
        tok = int(_sample_tokens(last[None])[0])  # the host sync
        t1 = time.perf_counter()
        _sm.PREFILL_MS.observe((t1 - t0) * 1e3)
        _sm.PREFILL_COUNT.inc()
        self.prefills += 1
        return self._finish_prefill(req, slot, tok, last)

    def _finish_prefill(self, req: Request, slot: int, tok: int,
                        last_logits) -> Optional[Request]:
        """Post-prefill bookkeeping: TTFT, first token, immediate
        retirement, slot arming."""
        cfg = self.cfg
        _sm.TOKENS_GENERATED.inc()
        now = time.perf_counter()
        req.first_token_t = now
        _sm.TTFT_MS.observe((now - req.submitted_t) * 1e3)
        req.tokens_out.append(tok)
        if cfg.collect_logits:
            self._captured_logits.setdefault(req.id, []).append(
                last_logits.float().cpu().numpy())
        if (cfg.eos_id is not None and tok == cfg.eos_id) \
                or req.max_new_tokens == 1:
            return self._retire(slot)
        self._len[slot] = req.prompt_len
        self._tok[slot] = tok
        self._active[slot] = True
        self._gen[slot] = 1
        self._maxnew[slot] = req.max_new_tokens
        return None

    # -- decode ---------------------------------------------------------------
    def _decode_dispatch(self) -> List[Request]:
        """One dispatch of ``decode_fuse`` decode steps over every slot,
        then ONE host sync for the emitted tokens and finish flags. Each
        step writes the consumed token's KV, picks the next token, and
        advances length/generated counts of the active slots; a slot
        finishes on EOS, on ``max_new_tokens`` or at ``max_seq``."""
        cfg = self.cfg
        steps = cfg.decode_fuse
        eos = -1 if cfg.eos_id is None else cfg.eos_id
        t0 = time.perf_counter()
        ln, tk, ac, gc = self._len, self._tok, self._active, self._gen
        outs, logseq = [], []
        for _ in range(steps):
            logits, self._cache = self.model.decode(
                self._cache, self.cache_ops, tk, ln, ac)
            nxt = torch.where(ac, _sample_tokens(logits), tk)
            emitted = ac
            gc = gc + ac
            ln = ln + ac
            fin = ac & ((nxt == eos) | (gc >= self._maxnew)
                        | (ln >= cfg.max_seq))
            ac = ac & ~fin
            tk = nxt
            outs.append(torch.stack([nxt, emitted.to(torch.int32),
                                     fin.to(torch.int32)]))
            if cfg.collect_logits:
                logseq.append(logits)
        self._len, self._tok, self._active, self._gen = ln, tk, ac, gc
        # one host sync per dispatch: the retire/admit decision needs the
        # emitted tokens
        toks, emitted, fin = torch.stack(outs, dim=1).cpu().numpy()
        if logseq:
            logseq = torch.stack(logseq).float().cpu().numpy()
        t1 = time.perf_counter()
        _sm.DECODE_STEP_MS.observe((t1 - t0) * 1e3)
        _sm.DECODE_DISPATCHES.inc()
        _sm.DECODE_STEPS.inc(steps)
        _sm.TOKENS_GENERATED.inc(int(emitted.sum()))
        self.decode_steps += steps
        finished: List[Request] = []
        for slot in range(cfg.slots):
            req = self.scheduler.slot_request(slot)
            if req is None:
                continue
            for f in range(steps):
                if emitted[f, slot]:
                    req.tokens_out.append(int(toks[f, slot]))
                    if cfg.collect_logits:
                        self._captured_logits.setdefault(req.id, []).append(
                            logseq[f, slot])
                if fin[f, slot]:
                    finished.append(self._retire(slot))
                    break
        return finished

    def _retire(self, slot: int) -> Request:
        """Every slot-vacating path funnels through here, so page
        reclamation can't be forgotten on a new path."""
        req = self.scheduler.retire(slot, FINISHED)
        if self.pool is not None and req.pages:
            self.pool.free(req.pages)
            req.pages = []
        req.finished_t = time.perf_counter()
        _sm.REQUEST_LATENCY_MS.observe(
            (req.finished_t - req.submitted_t) * 1e3)
        return req
