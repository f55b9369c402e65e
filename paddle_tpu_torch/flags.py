# ported from paddle_tpu/flags.py
"""Runtime flag system (reference: gflags DEFINE_* + the FLAGS_* env
whitelist in python/paddle/fluid/__init__.py:128-160).

Flags are read from ``FLAGS_*`` environment variables at import (the same
variables the JAX package reads) and mutable at runtime via set_flag().
Only the flags the ported paths read are defined. There is no
``strict_fused_attention``: the port never falls back from a kernel to its
plain version on a CUDA tensor, so there is nothing for it to forbid.
"""

from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["get_flag", "set_flag", "flags"]

_DEFAULTS: Dict[str, Any] = {
    "paged_attention_kernel": "auto", # ragged paged-attention CUDA decode
                                     # kernel (ops/kernels/paged_attention.py)
                                     # instead of the page gather +
                                     # decode_attention: "auto"/"on" = the
                                     # kernel for CUDA tensors; "off" =
                                     # always gather ("interpret" has no
                                     # meaning here and raises)
    "flash_attention_min_seq": 2048, # sdpa goes through the flash-attention
                                     # kernels (ops/kernels/flash_attention.py)
                                     # when max(Sq, Sk) reaches this, and is
                                     # composed below it. A routing rule
                                     # shared with the JAX package, so both
                                     # send a program to the same kind of
                                     # kernel; it depends on shapes only,
                                     # never on the device.
}

_flags: Dict[str, Any] = {}


def _coerce(default, raw: str):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, float):
        return float(raw)
    if isinstance(default, int):
        return int(raw)
    return raw


def _load_env():
    for name, default in _DEFAULTS.items():
        raw = os.environ.get("FLAGS_" + name)
        _flags[name] = _coerce(default, raw) if raw is not None else default


_load_env()


def get_flag(name: str):
    if name not in _flags:
        raise KeyError("unknown flag %r (known: %s)" % (name, sorted(_flags)))
    return _flags[name]


def set_flag(name: str, value):
    if name not in _flags:
        raise KeyError("unknown flag %r" % name)
    _flags[name] = value


class _Flags:
    def __getattr__(self, name):
        return get_flag(name)

    def __setattr__(self, name, value):
        set_flag(name, value)


flags = _Flags()
