# ported from paddle_tpu/passes/__init__.py
"""paddle_tpu_torch.passes — the default Program optimizer.

Fluid's L4 layer is an IR pass framework (``framework/ir/``) that rewrites
the program before execution; this package is its counterpart over the
Program IR (``core/framework.py``), as in the JAX package, run
AUTOMATICALLY by the Executor before it plans or captures a step (gated by
``PADDLE_TPU_OPT_LEVEL=0|1|2``, default 1):

* :mod:`~paddle_tpu_torch.passes.dce` — dead-op/dead-var elimination,
  liveness seeded from fetch targets + persistables (eval programs shed
  train-only ops).
* :mod:`~paddle_tpu_torch.passes.constant_fold` — evaluates, on CPU
  tensors, ops whose inputs are all constants (``fill_constant -> scale
  -> elementwise_*`` chains collapse to one constant).
* :mod:`~paddle_tpu_torch.passes.cse` — common-subexpression elimination
  keyed on (op type, value-numbered inputs, attrs).
* :mod:`~paddle_tpu_torch.passes.fuse_patterns` —
  ``softmax``+``cross_entropy`` -> the fused loss op (K2a/K2b on the
  card), and the unfused QKV-matmul/scale/softmax/matmul attention
  composition -> the ``scaled_dot_product_attention`` op (K1a-c from
  ``FLAGS_flash_attention_min_seq`` up).
* ``conv_bn_fuse_pass`` (``transpiler/fuse_passes.py``) joins the default
  pipeline for inference programs.

The port runs every op eagerly, so each op a pass removes is launches
saved on every eager step (and in every captured graph), and the rewrites
send primitive-built programs onto the hand-written kernels. Each pass
reports ``passes/<name>/ops_removed`` / ``rewrites_matched`` counters and
a ``passes/<name>/time_ms`` histogram via :mod:`paddle_tpu_torch.monitor`.
"""

from __future__ import annotations

# importing the modules registers the passes
from . import analysis, constant_fold, cse, dce, fuse_patterns  # noqa: F401
from .pipeline import (  # noqa: F401
    DEFAULT_PASS_NAMES, default_pipeline, maybe_optimize, opt_level,
    optimize_program, pass_enabled,
)

__all__ = [
    "DEFAULT_PASS_NAMES", "default_pipeline", "maybe_optimize", "opt_level",
    "optimize_program", "pass_enabled",
]
