# ported from paddle_tpu/contrib/slim/quantization/__init__.py
from .quantization_pass import (  # noqa: F401
    QuantizationFreezePass,
    QuantizationTransformPass,
    ConvertToInt8Pass,
)

__all__ = ["QuantizationTransformPass", "QuantizationFreezePass",
           "ConvertToInt8Pass"]
