# ported from paddle_tpu/contrib/slim/distillation/__init__.py
from .distillation_strategy import (  # noqa: F401
    DistillationStrategy,
    fsp_loss,
    l2_distill_loss,
    soft_label_loss,
)
