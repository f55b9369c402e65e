# ported from paddle_tpu/contrib/slim/distillation/distillation_strategy.py
"""Distillation scaffolding (reference direction: contrib/slim's
distillation strategies in later releases; the v1.3 tree carries only the
config hooks). Provides the standard distill losses as layer compositions
over a combined teacher+student program, plus a Strategy shell.
"""

from __future__ import annotations

from .... import layers
from ..core.strategy import Strategy

__all__ = ["soft_label_loss", "l2_distill_loss", "fsp_loss",
           "DistillationStrategy"]


def soft_label_loss(teacher_logits, student_logits, temperature=1.0):
    """KL(teacher_T || student_T) · T² — Hinton soft-label distillation."""
    t = float(temperature)
    teacher = layers.softmax(layers.scale(teacher_logits, scale=1.0 / t))
    log_p = layers.log_softmax(layers.scale(student_logits, scale=1.0 / t))
    ce = layers.reduce_sum(layers.elementwise_mul(teacher, log_p), dim=-1)
    return layers.scale(layers.mean(ce), scale=-(t * t))


def l2_distill_loss(teacher_feature, student_feature):
    """Feature-map L2 imitation loss."""
    diff = layers.elementwise_sub(teacher_feature, student_feature)
    return layers.mean(layers.square(diff))


def fsp_loss(teacher_a, teacher_b, student_a, student_b):
    """Flow-of-solution-procedure loss (Yim et al.): L2 between layer-pair
    Gram matrices. Inputs are [N, C, H, W] feature maps; a/b pairs must
    share spatial size."""

    def fsp_matrix(a, b):
        n, ca, h, w = a.shape
        cb = b.shape[1]
        af = layers.reshape(a, [n, ca, h * w])
        bf = layers.reshape(b, [n, cb, h * w])
        return layers.scale(
            layers.matmul(af, layers.transpose(bf, [0, 2, 1])),
            scale=1.0 / float(h * w))

    t = fsp_matrix(teacher_a, teacher_b)
    s = fsp_matrix(student_a, student_b)
    return l2_distill_loss(t, s)


class DistillationStrategy(Strategy):
    """Config shell: the distill loss is an ordinary layer composition added
    to the student's objective at graph-construction time (see the loss
    builders above); the strategy only gates which epochs train with it."""

    def __init__(self, distillers=None, start_epoch=0, end_epoch=10):
        super().__init__(start_epoch, end_epoch)
        self.distillers = distillers or []
