# ported from paddle_tpu/contrib/__init__.py
"""Contrib namespace (reference: python/paddle/fluid/contrib/): the
beam-search machinery (``decoder``), quantization (the QAT
``QuantizeTranspiler`` over the fake-quant ops), model compression
(``slim``: quantization passes, pruning, distillation), post-training int8
calibration (``int8_inference.Calibrator``) and the program utilities
``memory_usage`` and ``op_freq_statistic``."""

from . import decoder, int8_inference, quantize, slim, utils  # noqa: F401
from .int8_inference import Calibrator  # noqa: F401
from .quantize import QuantizeTranspiler  # noqa: F401
from .utils import memory_usage, op_freq_statistic  # noqa: F401
