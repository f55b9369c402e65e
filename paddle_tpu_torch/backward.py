# ported from paddle_tpu/backward.py
"""Static-graph autodiff API (reference: python/paddle/fluid/backward.py:394).

Fluid's ``append_backward`` walks the forward ops in reverse and appends
per-op grad ops built by C++ GradOpMakers. Here (as in the JAX package)
the API keeps its shape — it declares gradient variables (``p@GRAD``) and
marks the program — but the differentiation is done by the Executor:
``torch.autograd.grad`` over the forward ops it ran. User code (optimizers
reading ``param_to_grad``) is unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .core.framework import Parameter, Program, Variable, grad_var_name

__all__ = ["append_backward", "gradients", "calc_gradient"]


def _find_trainable_params(program: Program, parameter_list, no_grad_set) -> List[Parameter]:
    if parameter_list:
        names = set(p.name if isinstance(p, Variable) else p for p in parameter_list)
        params = [p for p in program.all_parameters() if p.name in names]
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    if no_grad_set:
        no_grad = set(v.name if isinstance(v, Variable) else v for v in no_grad_set)
        params = [p for p in params if p.name not in no_grad]
    return params


def _unique_grad_name(block, base: str) -> str:
    """A grad var name not yet taken in ``block`` (an earlier gradients()
    call may already have claimed ``x@GRAD``; silently aliasing the two would
    make one overwrite the other at execution)."""
    name, k = base, 0
    while block.has_var(name):
        k += 1
        name = "%s@RENAME@%d" % (base, k)
    return name


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence] = None,
    no_grad_set: Optional[set] = None,
    callbacks=None,
) -> List[Tuple[Parameter, Variable]]:
    """Mark the program for differentiation; returns [(param, grad_var), ...].

    The returned grad vars are bound at execution: the Executor computes
    ``jax.grad`` of the loss wrt each param and materializes the results
    under the ``p@GRAD`` names, so downstream ops (optimizers, grad clip,
    regularizers — which the Optimizer layer appends *after* the marker) see
    exactly what Fluid's appended grad ops would have produced.
    """
    program = loss.block.program
    block = program.global_block
    if program._backward_info is not None:
        raise RuntimeError("append_backward called twice on the same program")

    params = _find_trainable_params(program, parameter_list, no_grad_set)
    param_to_grad: Dict[str, str] = {}
    param_grads: List[Tuple[Parameter, Variable]] = []
    for p in params:
        gname = _unique_grad_name(block, grad_var_name(p.name))
        gvar = block.create_var(name=gname, shape=p.shape, dtype=p.dtype, stop_gradient=True)
        param_to_grad[p.name] = gname
        param_grads.append((p, gvar))

    loss_grad_name = _unique_grad_name(block, grad_var_name(loss.name))
    loss_grad = block.create_var(
        name=loss_grad_name, shape=loss.shape, dtype=loss.dtype, stop_gradient=True
    )
    block.append_op(
        "backward_marker",
        inputs={"Loss": loss},
        outputs={"ParamGrads": [g for _, g in param_grads]},
        attrs={"loss": loss.name, "param_to_grad": dict(param_to_grad)},
    )
    program._backward_info = {
        "loss": loss.name,
        "param_to_grad": param_to_grad,
        "loss_grad": loss_grad_name,
    }
    return param_grads


def _as_var_list(x) -> List[Variable]:
    if isinstance(x, Variable):
        return [x]
    return list(x)


def gradients(targets, inputs, target_gradients=None, no_grad_set=None) -> List[Variable]:
    """Compute d(targets)/d(inputs) (reference: backward.py:613 calc_gradient).

    Appends a ``calc_gradient`` op (``ops/gradient_ops.py``: it replays the
    op slice that makes the targets and takes ``torch.autograd.grad``).
    Returns one grad Variable per
    input; fetch them (or feed them onward) like any other var. May be called
    multiple times per program — each call differentiates the ops appended so
    far, so GAN-style per-loss gradients and double-grad (a later call whose
    prefix contains an earlier marker) both work.

    ``target_gradients`` seeds the vjp per target (default: ones, like the
    reference). ``no_grad_set`` names are treated as stop_gradient.
    Inputs with no path to any target yield zeros (the reference returns
    None; a traced program cannot know reachability per-element at trace
    time, so zeros are the functional equivalent).
    """
    targets = _as_var_list(targets)
    inputs = _as_var_list(inputs)
    if not targets or not inputs:
        raise ValueError("gradients() needs at least one target and one input")
    program = targets[0].block.program
    block = program.global_block

    if target_gradients is None:
        tg_list: List[Optional[Variable]] = [None] * len(targets)
    else:
        tg_list = _as_var_list(target_gradients)
        if len(tg_list) != len(targets):
            raise ValueError(
                "target_gradients must match targets: got %d vs %d"
                % (len(tg_list), len(targets)))
    no_grad_names = sorted(
        v.name if isinstance(v, Variable) else str(v) for v in (no_grad_set or ()))

    # Dedup repeated inputs: the env is keyed by name, so each name is one
    # leaf; duplicates share the grad var (the reference returns the same
    # gradient for each occurrence too).
    grad_by_name: Dict[str, Variable] = {}
    unique_inputs: List[Variable] = []
    for v in inputs:
        if v.name in grad_by_name:
            continue
        if v.dtype is not None and not str(v.dtype).startswith(("float", "bfloat")):
            raise TypeError(
                "gradients() input %r has non-differentiable dtype %s"
                % (v.name, v.dtype))
        gname = _unique_grad_name(block, grad_var_name(v.name))
        grad_by_name[v.name] = block.create_var(
            name=gname, shape=v.shape, dtype=v.dtype, stop_gradient=True)
        unique_inputs.append(v)
    grad_vars = [grad_by_name[v.name] for v in unique_inputs]

    op_inputs = {"Targets": targets, "Inputs": unique_inputs}
    tg_vars = [g for g in tg_list if g is not None]
    if tg_vars:
        op_inputs["TargetGradients"] = tg_vars
    block.append_op(
        "calc_gradient",
        inputs=op_inputs,
        outputs={"InputGrads": grad_vars},
        attrs={
            "targets": [t.name for t in targets],
            "inputs": [v.name for v in unique_inputs],
            "target_gradients": [g.name if g is not None else None for g in tg_list],
            "no_grad_set": no_grad_names,
        },
    )
    return [grad_by_name[v.name] for v in inputs]


calc_gradient = gradients
