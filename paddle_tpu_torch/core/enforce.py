# ported from paddle_tpu/core/enforce.py
"""Context-rich execution errors (reference: platform/enforce.h
PADDLE_ENFORCE / EnforceNotMet: every kernel failure carries the op, the
call site, and the message).

Here the equivalent moment is the interpreter's op loop: an op impl that
throws gets wrapped in ``EnforceNotMet`` carrying the op type, its
position, its input/output wiring and the best-available shapes — instead
of a bare KeyError/TypeError from deep inside torch.
"""

from __future__ import annotations

__all__ = ["EnforceNotMet", "enforce", "wrap_op_error"]


class EnforceNotMet(RuntimeError):
    """reference: platform/enforce.h:EnforceNotMet."""


def enforce(cond: bool, msg: str, *fmt_args):
    if not cond:
        raise EnforceNotMet(msg % fmt_args if fmt_args else msg)


def _var_desc(name, env, block):
    if env is not None and name in env:
        v = env[name]
        shp = getattr(v, "shape", None)
        dt = getattr(v, "dtype", None)
        return "%s[%s,%s]" % (name, list(shp) if shp is not None else "?", dt)
    if block is not None and block.has_var(name):
        v = block.var(name)
        return "%s[%s,%s](sym)" % (name, v.shape, v.dtype)
    return name + "[?]"


def _oom_hint(e: BaseException, op) -> str:
    """For a device-memory failure, the bytes the op asked for (its
    ``shape``/``dtype`` attrs), so the message says what did not fit."""
    txt = "%s: %s" % (type(e).__name__, e)
    if "out of memory" not in txt.lower():
        return ""
    detail = ""
    shape = op.attrs.get("shape")
    if shape:
        try:
            import numpy as np

            from .dtypes import to_torch_dtype

            n = int(np.prod([int(s) for s in shape]))
            itemsize = to_torch_dtype(op.attrs.get("dtype", "float32")).itemsize
            detail = " (requested %s = %d elements, %.2f GB)" % (
                list(shape), n, n * itemsize / 1e9)
        except Exception:
            pass
    return ("\n  hint: device memory exhausted allocating this op's "
            "output%s." % detail)


def wrap_op_error(e: BaseException, op, op_index: int, env=None) -> EnforceNotMet:
    """Build the enriched error for an op impl failure."""
    block = getattr(op, "block", None)
    ins = {slot: [_var_desc(n, env, block) for n in names]
           for slot, names in op.inputs.items()}
    outs = {slot: list(names) for slot, names in op.outputs.items()}
    msg = (
        "Operator %r (index %d) failed:\n"
        "  %s: %s\n"
        "  inputs:  %s\n"
        "  outputs: %s\n"
        "  attrs:   %s%s\n"
        "(reference parity: PADDLE_ENFORCE context, platform/enforce.h)"
        % (op.type, op_index, type(e).__name__, e, ins, outs,
           dict(op.attrs), _oom_hint(e, op))
    )
    return EnforceNotMet(msg)
