# ported from paddle_tpu/evaluator.py
"""Deprecated ``fluid.evaluator`` namespace (reference:
python/paddle/fluid/evaluator.py — each class there points users at the
``fluid.metrics`` replacement). Kept for script compatibility: the names
resolve to the metrics implementations."""

from .metrics import ChunkEvaluator, DetectionMAP, EditDistance  # noqa: F401

__all__ = ["ChunkEvaluator", "EditDistance", "DetectionMAP"]
