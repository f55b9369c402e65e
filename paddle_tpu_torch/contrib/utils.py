# ported from paddle_tpu/contrib/utils.py
"""Small contrib debug utilities.

``memory_usage`` — static per-program memory estimate (reference:
contrib/memory_usage_calc.py:46 ``memory_usage``): sum of op-output tensor
sizes with the batch dim substituted, returned as a (lower, upper, unit)
band. It is a sanity number before anything runs: the caching allocator
frees and reuses activations as the step goes, and a captured step holds
its own graph pool. The figure of a captured step is
``Executor.memory_report(program, feed=..., fetch_list=...)``: it prepares
the step (eager warm-ups on copies of the state, then the capture) and
returns its argument/output/alias/temp/peak bytes with the JAX package's
keys. This API exists for parity and for sizing a batch before paying for
that.

``op_freq_statistic`` — op-type frequency histogram (reference:
contrib/op_frequence.py ``op_freq_statistic``): single-op counts plus
adjacent-pair counts, useful for spotting fusion candidates in a Program.
"""

from __future__ import annotations

from collections import OrderedDict

from ..core.framework import Program

__all__ = ["memory_usage", "op_freq_statistic"]

_DTYPE_SIZE = {
    "float16": 2, "bfloat16": 2, "float32": 4, "float64": 8,
    "int16": 2, "int32": 4, "int64": 8, "bool": 1, "uint8": 1, "int8": 1,
}


def memory_usage(program: Program, batch_size: int):
    """Estimate a program's tensor memory at ``batch_size``.

    Returns ``(lower, upper, unit_str)`` — the reference's 5%-10% headroom
    band over the summed op-output sizes (batch dims, encoded as -1,
    multiplied out by ``batch_size``). For the authoritative compiled-step
    figure use ``Executor.memory_report`` (module docstring).
    """
    if not isinstance(program, Program):
        raise TypeError("Calculating Memory Usage requires Program as its "
                        "Parameter. But you passed in %s" % type(program))
    if batch_size <= 0:
        raise ValueError("The batch size need to be positive.")

    total = 0.0
    seen = set()
    block = program.global_block
    for op in block.ops:
        for var_name in op.output_arg_names:
            if var_name in seen:
                continue
            seen.add(var_name)
            var = block._find_var_recursive(var_name)
            if var is None or var.shape is None:
                continue
            count = 1
            neg_dims = 0
            for x in var.shape:
                if x is None:
                    continue
                if x < 0:
                    neg_dims += 1
                    if neg_dims > 1:
                        raise ValueError(
                            "Var %s has more than one negative dim" % var_name)
                    count *= batch_size * (-x)
                else:
                    count *= x
            total += count * _DTYPE_SIZE.get(str(var.dtype), 4)

    unit = "B"
    for u in ("KB", "MB"):
        if total > 1024:
            total /= 1024
            unit = u
    return total * 1.05, total * 1.1, unit


def op_freq_statistic(program: Program):
    """Op frequency statistics over block 0.

    Returns ``(uni_op_freq, adj_2_op_freq)`` — ordered dicts of single-op
    and adjacent-pair ("a->b") counts, most frequent first.
    """
    if not isinstance(program, Program):
        raise TypeError("The input type should be Program. But you passed "
                        "in %s" % type(program))
    uni = OrderedDict()
    adj = OrderedDict()
    prev = None
    for op in program.global_block.ops:
        uni[op.type] = uni.get(op.type, 0) + 1
        if prev is not None:
            key = "%s->%s" % (prev, op.type)
            adj[key] = adj.get(key, 0) + 1
        prev = op.type
    uni = OrderedDict(sorted(uni.items(), key=lambda kv: -kv[1]))
    adj = OrderedDict(sorted(adj.items(), key=lambda kv: -kv[1]))
    return uni, adj
