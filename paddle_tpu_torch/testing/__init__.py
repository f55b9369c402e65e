# ported from paddle_tpu/testing/__init__.py
from .op_test import OpTest, check_grad, check_output, run_op  # noqa: F401
