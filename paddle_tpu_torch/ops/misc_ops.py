# ported from paddle_tpu/ops/misc_ops.py
"""Host ops and SelectedRows ops: ``print``, ``py_func``, ``delete_var``,
``merge_selected_rows`` and ``get_tensor_from_selected_rows``
(reference: ``print_op.cc``, ``py_func_op.cc``,
``merge_selected_rows_op.cc``, ``get_tensor_from_selected_rows_op.cc``).

``print`` and ``py_func`` run Python on a host copy of their inputs
while the step runs: the JAX package taps them out of its compiled step
(``jax.debug.print``, ``jax.pure_callback``), which a CUDA graph cannot
do, so a program that holds one takes the eager step under
``CompiledProgram`` too (``executor.HOST_OPS``). ``py_func`` with a
backward callable is a ``torch.autograd.Function`` whose backward copies
the inputs and the output gradients to the host and the callable's
gradients back. ``delete_var`` drops its inputs from the step's values,
as in the JAX package, which is legal in a captured step too.

The SelectedRows ops take a rows-only gradient (``core.sparse.SparseGrad``,
the port's SelectedRows), as an ``is_sparse`` table's ``p@GRAD`` is.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..core.dtypes import to_torch_dtype
from ..core.registry import OpContext, register_op
from ..core.sparse import SparseGrad, merge_rows

# py_func's callables by handle: the op's attrs hold the integer, which a
# saved program can carry (the reference's PyFuncRegistry ids)
_PY_FUNCS: Dict[int, Callable] = {}


def register_py_func(fn: Callable) -> int:
    """Keep ``fn`` for ``py_func`` ops; returns its handle."""
    handle = len(_PY_FUNCS)
    _PY_FUNCS[handle] = fn
    return handle


def _host(t):
    return t.detach().cpu().numpy()


@register_op("print")
def print_op(ctx: OpContext):
    """reference: print_op.cc. Prints ``message`` and the tensor (its
    first ``summarize`` values when that is positive) on the first
    ``first_n`` runs of the op (every run when ``first_n`` < 0); ``Out``
    is the input itself, so the gradient passes through."""
    x = ctx.input("In" if ctx.has_input("In") else "X")
    first_n = int(ctx.attr("first_n", -1))
    calls = ctx.op.__dict__.get("_print_calls", 0)
    ctx.op.__dict__["_print_calls"] = calls + 1
    if first_n < 0 or calls < first_n:
        summarize = int(ctx.attr("summarize", -1))
        val = x.reshape(-1)[:summarize] if summarize > 0 else x
        print("%s %s" % (ctx.attr("message", "") or "", _host(val)),
              flush=True)
    ctx.set_output("Out", x)


def _out_specs(ctx):
    return [(tuple(v.shape), to_torch_dtype(v.dtype))
            for v in (ctx.op.block.var(n) for n in ctx.output_names("Out"))]


def _from_host(values, specs, device):
    values = values if isinstance(values, (list, tuple)) else [values]
    return tuple(torch.as_tensor(np.asarray(v)).to(device=device, dtype=dt)
                 .reshape(shape) for v, (shape, dt) in zip(values, specs))


class _PyFunc(torch.autograd.Function):
    """A host function with a host backward: the inputs and the output
    gradients go to the host, the callable's gradients come back."""

    @staticmethod
    def forward(ctx, fwd, bwd, specs, device, *xs):
        ctx.bwd = bwd
        ctx.save_for_backward(*xs)
        return _from_host(fwd(*[_host(x) for x in xs]), specs, device)

    @staticmethod
    def backward(ctx, *gs):
        xs = ctx.saved_tensors
        grads = _from_host(ctx.bwd(*[_host(x) for x in xs],
                                   *[_host(g) for g in gs]),
                           [(tuple(x.shape), x.dtype) for x in xs],
                           xs[0].device)
        return (None, None, None, None) + grads


@register_op("py_func")
def py_func_op(ctx: OpContext):
    """reference: py_func_op.cc. Runs the registered host function on host
    copies of the inputs; the outputs take the declared vars' shapes and
    dtypes. With a ``backward_callable_id``, the gradient runs the
    registered backward on (inputs, output gradients); without one no
    gradient passes, as in Fluid."""
    xs = ctx.inputs("X")
    fwd = _PY_FUNCS[int(ctx.attr("forward_callable_id"))]
    bwd_id = int(ctx.attr("backward_callable_id", -1))
    specs = _out_specs(ctx)
    if bwd_id >= 0:
        outs = _PyFunc.apply(fwd, _PY_FUNCS[bwd_id], specs, ctx.device, *xs)
    else:
        outs = _from_host(fwd(*[_host(x) for x in xs]), specs, ctx.device)
    ctx.set_outputs("Out", outs)


@register_op("delete_var")
def delete_var_op(ctx: OpContext):
    """reference: delete_var_op.cc frees scope tensors; here the inputs
    leave the step's values (the allocator frees what nothing else
    holds), as in the JAX package."""
    for names in ctx.op.inputs.values():
        for n in names:
            ctx.env.pop(n, None)


def _selected_rows(ctx: OpContext, op: str) -> SparseGrad:
    x = ctx.input("X")
    if not isinstance(x, SparseGrad):
        raise TypeError("%s expects a SelectedRows (SparseGrad) value, got "
                        "%r" % (op, type(x).__name__))
    return x


@register_op("merge_selected_rows")
def merge_selected_rows_op(ctx: OpContext):
    """reference: operators/merge_selected_rows_op.cc — sum rows with
    duplicate ids in a SelectedRows. Static-shape sort+segment-sum
    (core/sparse.py merge_rows); padded tail ids become out-of-range so a
    downstream scatter drops them."""
    x = _selected_rows(ctx, "merge_selected_rows")
    uniq, merged = merge_rows(x.ids, x.rows, invalid_index=2**31 - 1)
    ctx.set_output("Out", SparseGrad(uniq, merged))


@register_op("get_tensor_from_selected_rows")
def get_tensor_from_selected_rows_op(ctx: OpContext):
    """reference: operators/get_tensor_from_selected_rows_op.cc — expose a
    SelectedRows' value block as a dense [N, D] tensor (row i holds the
    contribution of table row ids[i])."""
    x = _selected_rows(ctx, "get_tensor_from_selected_rows")
    ctx.set_output("Out", x.rows)
