# ported from paddle_tpu/fleet/metrics.py
"""fleet/* instruments of the port: the prefix cache's counters only. The
router's, the replicas' and the phase ledger's instruments come with
``fleet/``'s router and ``serving/phases.py``."""

from __future__ import annotations

from ..monitor import metrics as _mx

__all__ = ["PREFIX_HITS", "PREFIX_MISSES", "PREFIX_INSERTS",
           "PREFIX_EVICTIONS", "PREFIX_ENTRIES", "PREFIX_PAGES",
           "PREFIX_TOKENS_REUSED", "PREFIX_POISONED_SKIPPED"]

PREFIX_HITS = _mx.counter(
    "fleet/prefix_cache/hits",
    help="prefill requests served from cached prefix KV pages (prefill "
         "compute skipped for the shared prefix)")
PREFIX_MISSES = _mx.counter(
    "fleet/prefix_cache/misses",
    help="prefill lookups that found no cached prefix")
PREFIX_INSERTS = _mx.counter(
    "fleet/prefix_cache/inserts",
    help="prefix entries inserted (pages donated by a FINISHED request)")
PREFIX_EVICTIONS = _mx.counter(
    "fleet/prefix_cache/evictions",
    help="LRU evictions under page-budget pressure")
PREFIX_ENTRIES = _mx.gauge(
    "fleet/prefix_cache/entries", help="live prefix entries")
PREFIX_PAGES = _mx.gauge(
    "fleet/prefix_cache/pages_held",
    help="KV pages owned by the prefix cache (counted by the engine's "
         "page-accounting invariant)")
PREFIX_TOKENS_REUSED = _mx.counter(
    "fleet/prefix_cache/tokens_reused",
    help="prompt tokens whose prefill compute was skipped via a cached "
         "prefix")
PREFIX_POISONED_SKIPPED = _mx.counter(
    "fleet/prefix_cache/poisoned_skipped",
    help="cacheable prefixes NOT inserted because their request did not "
         "FINISH (failed/timed-out pages are never served to a later "
         "request)")
