# ported from paddle_tpu/contrib/quantize/__init__.py
from .quantize_transpiler import QuantizeTranspiler  # noqa: F401
