# ported from paddle_tpu/contrib/slim/core/__init__.py
from .compress_pass import CompressPass, Context, build_compressor  # noqa: F401
from .strategy import Strategy  # noqa: F401
