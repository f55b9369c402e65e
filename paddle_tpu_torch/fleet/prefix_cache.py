# ported from paddle_tpu/fleet/prefix_cache.py
"""Token-prefix KV-page cache: reuse prefilled pages for shared prompts.

The paged layout (serving.kv_cache.PagedKVCache) stores a sequence's KV
rows in page-granular blocks, which makes "two requests share a system
prompt" a page-level fact: the first ``page_size``-aligned tokens of both
prompts produce identical KV pages. This module is the host-side index of
that fact:

* keys are :func:`prefix_key` — a SHA-1 over the raw token ids, stable
  across processes and Python hash randomization (a router and N worker
  replicas must agree on it);
* entries OWN their pages. The engine donates a FINISHED request's
  leading full pages instead of freeing them (zero-copy insert), and gets
  pages back to free on eviction/flush — so the cache can never leak and
  the engine's ``page_accounting_ok`` invariant extends to it;
* only FINISHED requests donate. A request that FAILED or timed out never
  inserts (``fleet/prefix_cache/poisoned_skipped``), so poisoned pages are
  structurally unservable, not filtered at lookup;
* bounded by a page budget with LRU eviction (``fleet/prefix_cache/*``
  counters account hits/misses/inserts/evictions/pages).

The cache is engine-agnostic bookkeeping: it never touches device memory.
The engine performs the device-side page copy + remainder ingest on a hit
(see ServingEngine._prefill_from_prefix).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from . import metrics as _fm

__all__ = ["PrefixCache", "PrefixEntry", "prefix_key"]


def prefix_key(tokens: Sequence[int]) -> str:
    """Stable cross-process key for a token prefix: SHA-1 over the ids'
    canonical text encoding (NOT Python ``hash()``, which is salted per
    process — a router and its worker replicas must derive the same key
    from the same tokens)."""
    data = ",".join(str(int(t)) for t in tokens).encode("ascii")
    return hashlib.sha1(data).hexdigest()


class PrefixEntry:
    """One cached prefix: the exact token ids it covers (verified on hit —
    the digest alone is not trusted) and the KV pages it owns."""

    __slots__ = ("key", "tokens", "pages", "hits")

    def __init__(self, key: str, tokens: Tuple[int, ...], pages: List[int]):
        self.key = key
        self.tokens = tokens
        self.pages = list(pages)
        self.hits = 0

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def __repr__(self):
        return ("PrefixEntry(tokens=%d, pages=%d, hits=%d)"
                % (len(self.tokens), len(self.pages), self.hits))


class PrefixCache:
    """LRU page-budgeted prefix index. All methods are host bookkeeping;
    page ownership moves through return values (the caller frees evicted
    pages back to ITS pool — the cache holds ids, never the pool)."""

    def __init__(self, page_budget: int, page_size: int):
        if page_budget < 1:
            raise ValueError("page_budget must be >= 1, got %d" % page_budget)
        if page_size < 1:
            raise ValueError("page_size must be >= 1, got %d" % page_size)
        self.page_budget = int(page_budget)
        self.page_size = int(page_size)
        # key -> entry, most-recently-used last (move_to_end on hit)
        self._entries: "OrderedDict[str, PrefixEntry]" = OrderedDict()
        self.pages_held = 0

    def __len__(self) -> int:
        return len(self._entries)

    def cacheable_len(self, prompt_len: int) -> int:
        """Longest page-aligned prefix STRICTLY shorter than the prompt
        (the remainder must keep >= 1 token: the first sampled token is
        keyed off the last prompt position, which must run through the
        ingest step on a hit)."""
        return ((int(prompt_len) - 1) // self.page_size) * self.page_size

    def contains(self, tokens: Sequence[int]) -> bool:
        e = self._entries.get(prefix_key(tokens))
        return e is not None and e.tokens == tuple(int(t) for t in tokens)

    def get(self, tokens: Sequence[int]) -> Optional[PrefixEntry]:
        """Exact-match accessor (token-verified, no LRU refresh, no
        hit/miss accounting) — the migration export path reads an entry
        without pretending a request was served from it."""
        e = self._entries.get(prefix_key(tokens))
        if e is not None and e.tokens == tuple(int(t) for t in tokens):
            return e
        return None

    def evict(self, tokens: Sequence[int]) -> List[int]:
        """Drop one exact entry; returns its pages for the caller to free
        ([] when absent). The rebalance path: ship a prefix to a peer,
        then evict here — export + evict = move, and the freed pages are
        the pool relief."""
        e = self.get(tokens)
        if e is None:
            return []
        del self._entries[e.key]
        self.pages_held -= len(e.pages)
        _fm.PREFIX_EVICTIONS.inc()
        self._export_gauges()
        return e.pages

    def lookup(self, prompt: Sequence[int]) -> Optional[PrefixEntry]:
        """Longest-match lookup for ``prompt``: probe page-aligned prefix
        lengths from the longest cacheable one down. A hit verifies token
        equality (never trusts the digest), refreshes LRU recency, and
        ticks the hit/tokens-reused counters; a full miss ticks misses."""
        ps = self.page_size
        prompt = [int(t) for t in prompt]
        for n in range(self.cacheable_len(len(prompt)), 0, -ps):
            key = prefix_key(prompt[:n])
            entry = self._entries.get(key)
            if entry is not None and entry.tokens == tuple(prompt[:n]):
                self._entries.move_to_end(key)
                entry.hits += 1
                _fm.PREFIX_HITS.inc()
                _fm.PREFIX_TOKENS_REUSED.inc(entry.n_tokens)
                return entry
        _fm.PREFIX_MISSES.inc()
        return None

    def insert(self, tokens: Sequence[int], pages: Sequence[int]
               ) -> Tuple[bool, List[int]]:
        """Register a prefix whose KV lives in ``pages`` (one page per
        ``page_size`` tokens, donated by the caller).

        Returns ``(accepted, evicted_pages)``: when accepted the cache now
        owns ``pages`` and the caller must free ``evicted_pages`` back to
        the pool; when refused (duplicate, over-budget even when empty, or
        length/page mismatch) the caller keeps ``pages`` and nothing was
        evicted."""
        tokens = tuple(int(t) for t in tokens)
        pages = list(pages)
        if (not tokens or not pages
                or len(tokens) != len(pages) * self.page_size
                or len(pages) > self.page_budget):
            return False, []
        key = prefix_key(tokens)
        if key in self._entries:
            return False, []
        evicted: List[int] = []
        while self.pages_held + len(pages) > self.page_budget:
            evicted.extend(self._evict_lru())
        self._entries[key] = PrefixEntry(key, tokens, pages)
        self.pages_held += len(pages)
        _fm.PREFIX_INSERTS.inc()
        self._export_gauges()
        return True, evicted

    def _evict_lru(self) -> List[int]:
        _key, entry = self._entries.popitem(last=False)
        self.pages_held -= len(entry.pages)
        _fm.PREFIX_EVICTIONS.inc()
        return entry.pages

    def flush(self) -> List[int]:
        """Drop every entry; returns ALL owned pages for the caller to
        free. Called when the device cache is reinitialized (a failed
        dispatch consumed the donated buffers — the rows backing these
        pages are gone) and at engine drain."""
        pages: List[int] = []
        for entry in self._entries.values():
            pages.extend(entry.pages)
        self._entries.clear()
        self.pages_held = 0
        self._export_gauges()
        return pages

    def _export_gauges(self) -> None:
        _fm.PREFIX_ENTRIES.set(len(self._entries))
        _fm.PREFIX_PAGES.set(self.pages_held)

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries),
                "pages_held": self.pages_held,
                "page_budget": self.page_budget,
                "hits": sum(e.hits for e in self._entries.values())}
