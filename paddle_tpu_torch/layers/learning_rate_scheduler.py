# ported from paddle_tpu/layers/learning_rate_scheduler.py
"""LR schedules as graph ops (reference: layers/learning_rate_scheduler.py).

Each scheduler builds a tiny op subgraph reading the auto-incremented global
step counter ``@LR_DECAY_COUNTER@``, exactly Fluid's design: the schedule is
part of the program, so it runs on the device inside the step (a captured
step too) and checkpoints with the counter. The counter is incremented once
a step however many schedules read it (``nn.autoincreased_step_counter``),
so a nested schedule such as ``linear_lr_warmup(polynomial_decay(...))``
reads one step, as in Fluid.
"""

from __future__ import annotations

import math

from . import nn, tensor
from .layer_helper import LayerHelper

__all__ = [
    "noam_decay",
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
    "cosine_decay",
    "linear_lr_warmup",
]


def _decay_step_counter(begin=0):
    counter = nn.autoincreased_step_counter(counter_name="@LR_DECAY_COUNTER@", begin=begin, step=1)
    return tensor.cast(counter, "float32")


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """lr = lr0 * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)."""
    step = _decay_step_counter(begin=1)
    a = nn.pow(step, -0.5)
    b = tensor.scale(step, scale=float(warmup_steps) ** -1.5)
    lr = nn.elementwise_min(a, b)
    return tensor.scale(lr, scale=float(learning_rate) * float(d_model) ** -0.5)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _decay_step_counter()
    div = tensor.scale(step, scale=1.0 / float(decay_steps))
    if staircase:
        helper = LayerHelper("floor")
        out = helper.create_variable_for_type_inference(div.dtype)
        helper.append_op("floor", inputs={"X": div}, outputs={"Out": out})
        div = out
    return tensor.scale(nn.elementwise_pow(
        tensor.fill_constant([1], "float32", decay_rate), div), scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _decay_step_counter()
    div = tensor.scale(step, scale=1.0 / float(decay_steps))
    if staircase:
        helper = LayerHelper("floor")
        out = helper.create_variable_for_type_inference(div.dtype)
        helper.append_op("floor", inputs={"X": div}, outputs={"Out": out})
        div = out
    helper = LayerHelper("exp")
    e = helper.create_variable_for_type_inference(div.dtype)
    helper.append_op("exp", inputs={"X": tensor.scale(div, scale=-float(decay_rate))},
                     outputs={"Out": e})
    return tensor.scale(e, scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _decay_step_counter()
    div = tensor.scale(step, scale=1.0 / float(decay_steps))
    if staircase:
        helper = LayerHelper("floor")
        out = helper.create_variable_for_type_inference(div.dtype)
        helper.append_op("floor", inputs={"X": div}, outputs={"Out": out})
        div = out
    denom = tensor.scale(div, scale=float(decay_rate), bias=1.0)
    one = tensor.fill_constant([1], "float32", float(learning_rate))
    return nn.elementwise_div(one, denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4, power=1.0, cycle=False):
    """lr = (lr0 - end)·(1 - min(step, decay_steps)/decay_steps)^power + end.
    ``cycle`` is accepted and ignored, as in the JAX package: the rate
    stays at ``end_learning_rate`` past ``decay_steps``."""
    step = _decay_step_counter()
    ds = tensor.fill_constant([1], "float32", float(decay_steps))
    capped = nn.elementwise_min(step, ds)
    frac = nn.elementwise_div(capped, ds)
    one_minus = tensor.scale(frac, scale=-1.0, bias=1.0)
    powd = nn.pow(one_minus, factor=float(power))
    return tensor.scale(powd, scale=float(learning_rate) - float(end_learning_rate),
                        bias=float(end_learning_rate))


def piecewise_decay(boundaries, values):
    """lr = values[i] for step in (boundaries[i-1], boundaries[i]]."""
    assert len(values) == len(boundaries) + 1
    step = _decay_step_counter()
    lr = tensor.fill_constant([1], "float32", float(values[0]))
    helper = LayerHelper("piecewise_decay")
    for b, v in zip(boundaries, values[1:]):
        # lr = step > b ? v : lr  — via where op
        cond = helper.create_variable_for_type_inference("bool")
        helper.append_op(
            "greater_than",
            inputs={"X": step, "Y": tensor.fill_constant([1], "float32", float(b))},
            outputs={"Out": cond},
        )
        lr = nn.where(cond, tensor.fill_constant([1], "float32", float(v)), lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """lr = 0.5 * lr0 * (1 + cos(pi * epoch / epochs))."""
    step = _decay_step_counter()
    epoch = tensor.scale(step, scale=1.0 / float(step_each_epoch))
    helper = LayerHelper("floor")
    epoch_f = helper.create_variable_for_type_inference("float32")
    helper.append_op("floor", inputs={"X": epoch}, outputs={"Out": epoch_f})
    helper2 = LayerHelper("cos")
    cosv = helper2.create_variable_for_type_inference("float32")
    helper2.append_op("cos", inputs={"X": tensor.scale(epoch_f, scale=math.pi / float(epochs))},
                      outputs={"Out": cosv})
    return tensor.scale(cosv, scale=0.5 * float(learning_rate), bias=0.5 * float(learning_rate))


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """Linear ramp start_lr→end_lr over warmup_steps, then learning_rate.

    ``learning_rate`` may be a float or a Variable from another scheduler.
    """
    from ..core.framework import Variable

    step = _decay_step_counter()
    ws = tensor.fill_constant([1], "float32", float(warmup_steps))
    frac = nn.elementwise_div(nn.elementwise_min(step, ws), ws)
    warm = tensor.scale(frac, scale=float(end_lr) - float(start_lr), bias=float(start_lr))
    if not isinstance(learning_rate, Variable):
        learning_rate = tensor.fill_constant([1], "float32", float(learning_rate))
    helper = LayerHelper("warmup_switch")
    cond = helper.create_variable_for_type_inference("bool")
    helper.append_op("less_than", inputs={"X": step, "Y": ws}, outputs={"Out": cond})
    return nn.where(cond, warm, learning_rate)


def append_LARS(params_grads, learning_rate, weight_decay):
    """LARS layer-wise lr scaling (reference:
    layers/learning_rate_scheduler.py append_LARS):
    lr_i = lr · ||p|| / (||g|| + weight_decay·||p||) per parameter.
    Returns the list of per-parameter decayed learning rates. (For the
    optimizer-integrated variant see optimizer.LarsMomentumOptimizer.)"""
    from . import nn, tensor

    decayed = []
    for param, grad in params_grads:
        p_norm = nn.sqrt(nn.reduce_sum(nn.square(param)))
        g_norm = nn.sqrt(nn.reduce_sum(nn.square(grad)))
        # reference _balanced_weight: wd == 1.0 → ||g|| + ||p||, else
        # ||g|| + wd·||p||
        ratio = nn.elementwise_add(
            g_norm, p_norm if weight_decay == 1.0
            else tensor.scale(p_norm, scale=float(weight_decay)))
        local = nn.elementwise_div(p_norm, ratio)
        decayed.append(nn.elementwise_mul(local, learning_rate)
                       if hasattr(learning_rate, "name")
                       else tensor.scale(local, scale=float(learning_rate)))
    return decayed


__all__.append("append_LARS")
