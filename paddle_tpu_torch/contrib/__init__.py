# ported from paddle_tpu/contrib/__init__.py
"""Contrib namespace (reference: python/paddle/fluid/contrib/). Of the
JAX package's contrib areas the port has ``decoder`` (the beam-search
machinery re-exported); quantize, slim, int8_inference and utils wait for
ROADMAP Queue 1 item 8."""

from . import decoder  # noqa: F401
