# ported from paddle_tpu/serving/metrics.py
"""serving/* instruments: the monitor-registry face of the serving stack.

One module owns every ``serving/*`` name so the scheduler, page pool and
decode driver never race a get-or-create. Module-level handles, a single
disabled-branch per call. The names are the JAX package's.
"""

from __future__ import annotations

from ..monitor import metrics as _mx

__all__ = [
    "REQUESTS_SUBMITTED", "REQUESTS_ADMITTED", "REQUESTS_RETIRED",
    "REQUESTS_REJECTED", "QUEUE_DEPTH", "SLOT_OCCUPANCY",
    "PAGES_IN_USE", "PAGE_POOL_UTILIZATION", "ADMISSION_BLOCKED",
    "PREFILL_COUNT", "DECODE_STEPS", "DECODE_DISPATCHES",
    "TOKENS_GENERATED", "TOKENS_PER_SEC",
    "REQUEST_LATENCY_MS", "TTFT_MS", "DECODE_STEP_MS", "PREFILL_MS",
    "FAULTS", "RETRIES", "TIMEOUTS", "REQUESTS_FAILED",
    "DRAINS", "DRAINED_REQUESTS", "DRAIN_REJECTED",
    "SPEC_PROPOSED", "SPEC_ACCEPTED", "SPEC_REJECTED", "SPEC_DRAFTS",
    "SPEC_VERIFY_DISPATCHES", "SPEC_ACCEPT_RATE",
]

REQUESTS_SUBMITTED = _mx.counter(
    "serving/requests_submitted", help="requests accepted into the queue")
REQUESTS_ADMITTED = _mx.counter(
    "serving/requests_admitted", help="requests admitted into a batch slot")
REQUESTS_RETIRED = _mx.counter(
    "serving/requests_retired", help="requests finished and retired")
REQUESTS_REJECTED = _mx.counter(
    "serving/requests_rejected",
    help="submissions rejected with BackpressureError (queue full)")
QUEUE_DEPTH = _mx.gauge(
    "serving/queue_depth", help="requests waiting for a slot")
SLOT_OCCUPANCY = _mx.gauge(
    "serving/slot_occupancy", help="batch slots currently running a request")
PAGES_IN_USE = _mx.gauge(
    "serving/page_pool_pages_in_use", help="KV-cache pages currently allocated")
PAGE_POOL_UTILIZATION = _mx.gauge(
    "serving/page_pool_utilization", help="pages_in_use / num_pages, 0..1")
ADMISSION_BLOCKED = _mx.counter(
    "serving/admission_blocked_on_pages",
    help="admission attempts deferred because the page pool could not "
         "cover the request's worst-case page need (backpressure, not crash)")
PREFILL_COUNT = _mx.counter(
    "serving/prefills", help="prefill invocations")
DECODE_STEPS = _mx.counter(
    "serving/decode_steps", help="decode steps executed (all slots at once)")
DECODE_DISPATCHES = _mx.counter(
    "serving/decode_dispatches",
    help="decode dispatches issued (each fuses >=1 decode steps)")
TOKENS_GENERATED = _mx.counter(
    "serving/tokens_generated", help="tokens emitted to finished+running requests")
TOKENS_PER_SEC = _mx.gauge(
    "serving/tokens_per_sec",
    help="sustained generation rate over the last engine.run() drive")
REQUEST_LATENCY_MS = _mx.histogram(
    "serving/request_latency_ms",
    help="submit -> finish wall time per retired request")
TTFT_MS = _mx.histogram(
    "serving/ttft_ms", help="submit -> first token wall time per request")
DECODE_STEP_MS = _mx.histogram(
    "serving/decode_step_ms",
    help="host wall time of one decode dispatch / fused steps")
PREFILL_MS = _mx.histogram(
    "serving/prefill_ms", help="host wall time of one prefill call")
FAULTS = _mx.counter(
    "serving/faults",
    help="decode dispatch failures absorbed by the recovery path (the "
         "in-flight batch was failed, the engine kept serving)")
RETRIES = _mx.counter(
    "serving/retries",
    help="decode dispatches retried after a transient-classified failure")
TIMEOUTS = _mx.counter(
    "serving/timeouts",
    help="requests retired with TIMEOUT status at their deadline (queued "
         "or running; slots and pages reclaimed)")
REQUESTS_FAILED = _mx.counter(
    "serving/requests_failed",
    help="requests retired as FAILED when their in-flight batch was lost "
         "to a decode failure")
DRAINS = _mx.counter(
    "serving/drains",
    help="graceful drains performed (stop admitting, finish in-flight, "
         "close) — SIGTERM/rollout shutdowns, not crashes")
DRAINED_REQUESTS = _mx.counter(
    "serving/drained_requests",
    help="in-flight requests that FINISHED during a graceful drain")
DRAIN_REJECTED = _mx.counter(
    "serving/drain_rejected",
    help="requests rejected because the engine was draining (typed "
         "DrainingError at submit, plus queued requests shed at drain "
         "start)")
SPEC_PROPOSED = _mx.counter(
    "serving/spec_proposed_tokens",
    help="draft tokens proposed to speculative verify dispatches")
SPEC_ACCEPTED = _mx.counter(
    "serving/spec_accepted_tokens",
    help="draft tokens accepted by the target model (each one is a decode "
         "step the engine did not have to dispatch)")
SPEC_REJECTED = _mx.counter(
    "serving/spec_rejected_tokens",
    help="draft tokens rejected (or cut by eos/budget) and rolled back — "
         "their KV rows sit beyond ctx_len until overwritten")
SPEC_DRAFTS = _mx.counter(
    "serving/spec_drafts",
    help="non-empty per-slot drafts submitted to verify dispatches")
SPEC_VERIFY_DISPATCHES = _mx.counter(
    "serving/spec_verify_dispatches",
    help="decode dispatches that took the speculative verify-window path")
SPEC_ACCEPT_RATE = _mx.histogram(
    "serving/spec_accept_rate",
    help="per-dispatch accepted/proposed draft-token ratio, 0..1")
