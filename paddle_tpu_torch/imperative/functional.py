# ported from paddle_tpu/imperative/functional.py
"""Eager functional ops for dygraph code.

Thin wrappers over ``tracer.dispatch`` onto the registered op impls — the
same ops static programs run, eagerly with autograd. The reference reuses
its ``fluid.layers.*`` functions in imperative mode via the tracer hook;
here the explicit functional namespace keeps the static layer builders
(which infer shapes on symbolic Variables) apart from eager execution.
``softmax_with_cross_entropy`` reaches the softmax cross-entropy kernels
K2a/K2b on the card, as the static op does.
"""

from __future__ import annotations

import torch

from .tracer import dispatch, trace_fn

__all__ = [
    "relu", "sigmoid", "tanh", "softmax", "mean", "reduce_sum", "reshape",
    "cross_entropy", "softmax_with_cross_entropy", "dropout", "concat",
    "matmul", "log_softmax", "square", "sqrt", "exp", "log", "accuracy",
]


def _unary(op):
    def f(x):
        return dispatch(op, {"X": x})

    f.__name__ = op
    return f


relu = _unary("relu")
sigmoid = _unary("sigmoid")
tanh = _unary("tanh")
square = _unary("square")
sqrt = _unary("sqrt")
exp = _unary("exp")
log = _unary("log")


def softmax(x, axis=-1):
    return dispatch("softmax", {"X": x}, attrs={"axis": axis})


def log_softmax(x, axis=-1):
    return dispatch("log_softmax", {"X": x}, attrs={"axis": axis})


def mean(x):
    return dispatch("mean", {"X": x})


def reduce_sum(x, dim=None, keep_dim=False):
    return dispatch("reduce_sum", {"X": x},
                    attrs={"dim": dim, "keep_dim": keep_dim,
                           "reduce_all": dim is None})


def reshape(x, shape):
    return dispatch("reshape2", {"X": x}, attrs={"shape": list(shape)})


def concat(xs, axis=0):
    return dispatch("concat", {"X": list(xs)}, attrs={"axis": axis})


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0):
    return dispatch("matmul", {"X": x, "Y": y},
                    attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
                           "alpha": alpha})


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    return dispatch("cross_entropy", {"X": input, "Label": label},
                    attrs={"soft_label": soft_label, "ignore_index": ignore_index})


def softmax_with_cross_entropy(logits, label, soft_label=False):
    """The loss alone: with no ``Softmax`` output asked for, hard labels
    take K2a/K2b on the card (the JAX package's op computes both)."""
    return dispatch("softmax_with_cross_entropy",
                    {"Logits": logits, "Label": label},
                    attrs={"soft_label": soft_label}, out_slots=("Loss",))


def dropout(x, dropout_prob=0.5, is_test=None, seed=0):
    return dispatch("dropout", {"X": x},
                    attrs={"dropout_prob": dropout_prob, "seed": seed},
                    is_test=is_test)


def accuracy(input, label, k=1):
    def acc(logits, lab):
        pred = torch.argmax(logits, dim=-1)
        return (pred == lab.reshape(pred.shape)).float().mean()

    return trace_fn(acc, input, label)
