# ported from paddle_tpu/fleet/__init__.py
"""paddle_tpu_torch.fleet — the token-prefix KV-page cache a serving engine
keeps (``ServingConfig(prefix_cache_pages=...)``). The router, replicas
and page migration between processes are not ported yet."""

from .prefix_cache import PrefixCache, PrefixEntry, prefix_key  # noqa: F401

__all__ = ["PrefixCache", "PrefixEntry", "prefix_key"]
