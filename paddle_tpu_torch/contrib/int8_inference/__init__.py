# ported from paddle_tpu/contrib/int8_inference/__init__.py
"""Post-training int8 calibration (reference:
python/paddle/fluid/contrib/int8_inference/utility.py — Calibrator)."""

from .calibrator import Calibrator  # noqa: F401

__all__ = ["Calibrator"]
