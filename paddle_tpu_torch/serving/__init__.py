# ported from paddle_tpu/serving/__init__.py
"""paddle_tpu_torch.serving — continuous batching, paged KV-cache, decode
driver, on a CUDA GPU.

* :class:`~.scheduler.Scheduler`: bounded FIFO queue → fixed batch slots,
  with continuous (in-flight) admission each decode dispatch,
* :class:`~.page_pool.PagePool` + :class:`~.kv_cache.PagedKVCache`: fixed
  device pages and per-request page tables, so ragged sequence lengths pay
  for pages, not padding; decode attention reads the pages through the
  hand-written CUDA kernel (ops/kernels/paged_attention.py),
* :class:`~.engine.ServingEngine`: per-bucket prefill + decode dispatches
  with all serving state on the device, the decode (and speculative
  verify) dispatch replayed from a CUDA graph on the card
  (serving.captured); seeded sampled decoding (core.threefry), n-gram
  speculation (serving.speculative), the prefix cache
  (paddle_tpu_torch.fleet.prefix_cache), drain, deadlines and the
  retry/fail ladder (paddle_tpu_torch.reliability.faults),
* ``serving/*`` monitor counters + latency histograms.

Quick start::

    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import decoder_lm

    model = decoder_lm.DecoderLM(decoder_lm.DecoderConfig(max_seq=128))
    eng = serving.ServingEngine(model, serving.ServingConfig(
        slots=8, page_size=16, max_seq=128))
    reqs = [eng.submit([1, 2, 3], max_new_tokens=16) for _ in range(32)]
    reqs.append(eng.submit([4, 5, 6], 16, temperature=0.8, top_k=40,
                           seed=7))
    eng.run()                 # drains queue+slots, continuous batching
    print(reqs[0].tokens_out, reqs[0].latency_s)

Both constructors take ``device=None`` (the card; raises without one) or
``device="cpu"``.
"""

from .engine import ServingConfig, ServingEngine  # noqa: F401
from .kv_cache import ContiguousKVCache, PagedKVCache  # noqa: F401
from .page_pool import PagePool, PagePoolExhausted  # noqa: F401
from .request import (  # noqa: F401
    FAILED, FINISHED, QUEUED, REJECTED, RUNNING, TIMEOUT, BackpressureError,
    DrainingError, Request)
from .scheduler import Scheduler  # noqa: F401

__all__ = [
    "ServingConfig", "ServingEngine",
    "PagedKVCache", "ContiguousKVCache",
    "PagePool", "PagePoolExhausted",
    "Scheduler", "Request", "BackpressureError", "DrainingError",
    "QUEUED", "RUNNING", "FINISHED", "TIMEOUT", "FAILED", "REJECTED",
]
