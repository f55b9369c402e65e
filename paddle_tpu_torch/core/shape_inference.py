# ported from paddle_tpu/core/shape_inference.py
"""Shape/dtype inference by abstract evaluation.

Fluid hand-writes an InferShape function per op (~430 of them, e.g.
``framework/operator.cc:930`` runtime InferShape). Here, as in the JAX
package, shapes are derived from the op implementations themselves: each
appended op runs once over tensors on torch's ``meta`` device (shape and
dtype, no data, no FLOPs), so shape inference cannot disagree with the op.
Dynamic (batch) dims are threaded through as a sentinel value and mapped
back to -1.
"""

from __future__ import annotations

import torch

from .dtypes import convert_dtype, to_torch_dtype

# Placeholder for dynamic (-1) dims during abstract eval. Prime & unusual to
# make accidental collision with a real static dim unlikely.
DYNAMIC_SENTINEL = 509

_META = torch.device("meta")


def _subst_dynamic(shape):
    return tuple(DYNAMIC_SENTINEL if d == -1 else d for d in shape)


def _restore_dynamic(shape):
    return tuple(-1 if d == DYNAMIC_SENTINEL else d for d in shape)


class _Trace:
    """The interpreter's trace, for one abstract evaluation: training mode,
    meta tensors, no random generator (meta tensors draw nothing)."""

    is_test = False
    current_op_idx = 0
    device = _META

    def op_rng(self, ctx):
        return None


def infer_op_shapes(op, block) -> None:
    """Best-effort: fills in shape/dtype of output vars with unknown shape.

    Silently skips ops it cannot evaluate (unregistered type, inputs with
    unknown shapes, data-dependent shapes); the run remains the source of
    truth.
    """
    from .registry import OpContext, get_op_impl, has_op

    if not has_op(op.type):
        return

    env = {}
    for names in op.inputs.values():
        for n in names:
            v = block._find_var_recursive(n)
            if v is None or v.shape is None:
                return  # unknown input — give up
            env[n] = torch.empty(_subst_dynamic(v.shape),
                                 dtype=to_torch_dtype(v.dtype), device=_META)

    out_names = [n for names in op.outputs.values() for n in names]
    try:
        with torch.no_grad():
            get_op_impl(op.type)(OpContext(op, env, _Trace()))
    except Exception:
        return

    for n in out_names:
        t = env.get(n)
        v = block._find_var_recursive(n)
        if v is None or not isinstance(t, torch.Tensor):
            continue
        if v.shape is None:
            v.shape = _restore_dynamic(t.shape)
            v.dtype = convert_dtype(t.dtype)
