# ported from paddle_tpu/core/unique_name.py
"""Unique name generator (reference: python/paddle/fluid/unique_name.py)."""

from __future__ import annotations

import contextlib
from collections import defaultdict

__all__ = ["generate", "guard", "switch"]


class NameGenerator:
    def __init__(self):
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        name = "%s_%d" % (key, self.ids[key])
        self.ids[key] += 1
        return name


_generator = NameGenerator()


def generate(key: str) -> str:
    return _generator(key)


def switch(new_generator=None):
    global _generator
    prev = _generator
    _generator = new_generator or NameGenerator()
    return prev


@contextlib.contextmanager
def guard(new_generator=None):
    prev = switch(new_generator)
    try:
        yield
    finally:
        switch(prev)
