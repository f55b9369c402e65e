# ported from paddle_tpu/ops/pallas_kernels/sparse_adam.py
"""Row-wise sparse optimizer updates (lazy Adam and SGD): the CUDA kernels
and their plain versions.

The CTR tables are the largest state of a DeepFM step ([V, D] with V up to
5e7), but a step touches only the rows its batch looked up. After
``core.sparse.merge_rows`` the gradient is (ids [N], rows [N, D]) with
unique ids and a padding tail of id V; the kernels
(``paddle_tpu_torch/csrc/sparse_adam.cu``) read and write only the rows the
ids name, in place, so the cost of a step does not grow with V:

* K4a :func:`sparse_adam_rows`: lazy Adam, moments decay and parameters
  move only on touched rows;
* K4b :func:`sparse_sgd_rows`: ``p[id] -= lr · row``.

Both require merged ids: the kernels write each named row from one thread
(or one group of lanes) and have no atomics, so two equal ids would race.
Padding ids (== V) and ids below 0 touch nothing. A thread loads a row in
the widest vector its alignment allows (:func:`vector_width`), so a table
view whose storage offset breaks 16 bytes takes a narrower instantiation
of the same kernel, and one off 8 bytes the scalar one.

The wrappers take the plain versions (:func:`sparse_adam_rows_reference`,
:func:`sparse_sgd_rows_reference`) for tensors on the CPU and, for CUDA
tensors, launch the kernel or raise: nothing falls back from a kernel to
the plain version. Both routes update the tables in place and return them,
so a caller that holds a table sees the update either way. Each kernel
launch adds one to :data:`LAUNCHES_ADAM` or :data:`LAUNCHES_SGD`; with no
ids (N = 0) nothing is launched.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["sparse_adam_rows", "sparse_sgd_rows",
           "sparse_adam_rows_reference", "sparse_sgd_rows_reference",
           "sparse_rows_supported", "adam_constants", "vector_width",
           "load_width", "bind", "launch", "LAUNCHES_ADAM", "LAUNCHES_SGD"]

LAUNCHES_ADAM = 0  # K4a launches since import (or since a caller reset it)
LAUNCHES_SGD = 0   # K4b launches

_fns = None


def bind(lib):
    """(adam, sgd): the C entry points of a loaded ``sparse_adam`` library
    with their argument types set."""
    adam, sgd = lib.sparse_adam_rows, lib.sparse_sgd_rows
    # p, m, v, ids, rows, lr_t, n, d, vocab, b1, 1-b1, b2, 1-b2, eps, vec,
    # stream
    adam.argtypes = ([ctypes.c_void_p] * 6
                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
                     + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
    # p, ids, rows, lr, n, d, vocab, vec, stream
    sgd.argtypes = ([ctypes.c_void_p] * 4
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
                    + [ctypes.c_int, ctypes.c_void_p])
    adam.restype = sgd.restype = ctypes.c_int
    return adam, sgd


def _kernels():
    global _fns
    if _fns is None:
        _fns = bind(_build.load("sparse_adam"))
    return _fns


def sparse_rows_supported(*tables) -> bool:
    """The kernels take float32 tables (the CTR workload) only; the
    optimizer ops send any other dtype to the composed scatter
    formulation, as the JAX package's gate does."""
    return all(t.dtype == torch.float32 for t in tables)


def adam_constants(beta1, beta2, epsilon):
    """(b1, 1-b1, b2, 1-b2, eps) rounded to float32, as Python floats: the
    one-minus terms computed in float32, so torch multiplies a float32
    tensor by exactly the constants the JAX package uses."""
    f = np.float32
    return (float(f(beta1)), float(f(1) - f(beta1)), float(f(beta2)),
            float(f(1) - f(beta2)), float(f(epsilon)))


def vector_width(d, *ptrs):
    """Floats a thread moves with one load or store of a row: 4 where
    ``d % 4 == 0`` and every pointer (the tables', the gradient rows') lies
    on 16 bytes, 2 where ``d`` is even and they lie on 8, else 1. Every row
    of a [*, d] float32 tensor at such a base then starts on the same
    boundary."""
    for w in (4, 2):
        if d % w == 0 and all(p % (4 * w) == 0 for p in ptrs):
            return w
    return 1


def load_width(tables, rows):
    """:func:`vector_width` of [V, D] ``tables`` and [N, D] gradient
    ``rows``: the C entry points' ``vec`` argument."""
    return vector_width(tables[0].shape[1], rows.data_ptr(),
                        *(t.data_ptr() for t in tables))


def _check(tables, ids, rows, lr):
    p = tables[0]
    if p.dim() != 2:
        raise ValueError("tables must be [V, D], got shape %s"
                         % (tuple(p.shape),))
    for t in tables:
        if t.shape != p.shape or t.dtype != torch.float32:
            raise TypeError("tables must be float32 [V, D] of one shape, got "
                            "%s %s" % (t.dtype, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("tables are updated in place and must be "
                             "contiguous")
    if ids.dim() != 1 or ids.dtype != torch.int64:
        raise TypeError("ids must be [N] int64, got %s %s"
                        % (ids.dtype, tuple(ids.shape)))
    if tuple(rows.shape) != (ids.shape[0], p.shape[1]) \
            or rows.dtype != torch.float32:
        raise TypeError("rows must be float32 [%d, %d], got %s %s"
                        % (ids.shape[0], p.shape[1], rows.dtype,
                           tuple(rows.shape)))
    if lr.numel() != 1 or lr.dtype != torch.float32:
        raise TypeError("the step size must be one float32, got %s %s"
                        % (lr.dtype, tuple(lr.shape)))
    devs = {t.device for t in (*tables, ids, rows, lr)}
    if len(devs) != 1:
        raise ValueError("tensors on several devices: %s" % sorted(map(str,
                                                                       devs)))
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError("sparse rows updates run on cuda or cpu, got %s"
                         % p.device)


def launch(fn, dev, *args):
    """Call the C entry point ``fn`` on ``dev``'s current stream with the
    tensors of ``args`` as device pointers; raises on a launch error."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        err = fn(*ptrs, stream)
    if err != 0:
        raise RuntimeError("sparse rows kernel launch failed: cudaError_t %d"
                           % err)


def _as_lr(lr, like):
    if isinstance(lr, torch.Tensor):
        return lr.reshape(1).contiguous()
    return torch.tensor([lr], dtype=torch.float32, device=like.device)


def sparse_adam_rows(param, moment1, moment2, ids, rows, lr_t, beta1=0.9,
                     beta2=0.999, epsilon=1e-8):
    """Lazy Adam over merged sparse rows, in place (K4a on CUDA tensors,
    the plain version on CPU tensors).

    ``param``/``moment1``/``moment2``: contiguous [V, D] float32 tables.
    ``ids``: [N] int64 merged unique row ids, padding entries == V.
    ``rows``: [N, D] float32 merged gradient rows. ``lr_t``: the
    bias-corrected step size ``lr·sqrt(1-β2^t)/(1-β1^t)`` as a one-element
    float32 tensor on the tables' device (a Python float is copied there).
    Returns (param, moment1, moment2), the same tensors."""
    global LAUNCHES_ADAM
    lr_t = _as_lr(lr_t, param)
    _check((param, moment1, moment2), ids, rows, lr_t)
    if param.device.type == "cpu":
        return sparse_adam_rows_reference(param, moment1, moment2, ids, rows,
                                          lr_t, beta1, beta2, epsilon)
    _build.refuse_export("K4a (sparse_adam_rows)")
    if ids.shape[0] == 0:
        return param, moment1, moment2
    ids, rows = ids.contiguous(), rows.contiguous()
    vocab, d = param.shape
    adam, _ = _kernels()
    launch(adam, param.device, param, moment1, moment2, ids, rows, lr_t,
           ids.shape[0], d, vocab, *adam_constants(beta1, beta2, epsilon),
           load_width((param, moment1, moment2), rows))
    LAUNCHES_ADAM += 1
    return param, moment1, moment2


def sparse_sgd_rows(param, ids, rows, lr):
    """SGD over merged sparse rows, in place: rows of ``param`` at ``ids``
    get ``-lr·rows``; padding ids (== V) are dropped (K4b on CUDA tensors,
    the plain version on CPU tensors). ``lr`` as for
    :func:`sparse_adam_rows`. Returns ``param``."""
    global LAUNCHES_SGD
    lr = _as_lr(lr, param)
    _check((param,), ids, rows, lr)
    if param.device.type == "cpu":
        return sparse_sgd_rows_reference(param, ids, rows, lr)
    _build.refuse_export("K4b (sparse_sgd_rows)")
    if ids.shape[0] == 0:
        return param
    ids, rows = ids.contiguous(), rows.contiguous()
    vocab, d = param.shape
    _, sgd = _kernels()
    launch(sgd, param.device, param, ids, rows, lr, ids.shape[0], d, vocab,
           load_width((param,), rows))
    LAUNCHES_SGD += 1
    return param


def _gather_index(ids, vocab):
    """(ids clamped into the table, mask of the ids that name a row)."""
    return ids.clamp(0, vocab - 1), (ids >= 0) & (ids < vocab)


def sparse_adam_rows_reference(param, moment1, moment2, ids, rows, lr_t,
                               beta1=0.9, beta2=0.999, epsilon=1e-8):
    """The plain version of K4a, in place: the scatter formulation of the
    JAX package's ``adam_op`` — gather the rows at the clamped ids, then
    add the deltas with ``index_add_``. A padding id adds -0.0 to the row
    it clamps to, which leaves every value as it was, -0.0 included. The
    arithmetic is in float32; each table takes its delta in its own
    dtype."""
    b1, omb1, b2, omb2, eps = adam_constants(beta1, beta2, epsilon)
    idx, valid = _gather_index(ids, param.shape[0])
    lr_t = lr_t.reshape(()).float()
    g = rows.float()
    m_old, v_old = moment1[idx].float(), moment2[idx].float()
    m_rows = m_old * b1 + g * omb1
    v_rows = v_old * b2 + g.square() * omb2
    step = lr_t * m_rows / (v_rows.sqrt() + eps)
    keep = valid[:, None]
    for table, delta in ((param, -step), (moment1, m_rows - m_old),
                         (moment2, v_rows - v_old)):
        table.index_add_(0, idx, torch.where(keep, delta, -0.0)
                         .to(table.dtype))
    return param, moment1, moment2


def sparse_sgd_rows_reference(param, ids, rows, lr):
    """The plain version of K4b, in place: ``index_add_`` of ``-lr·rows``
    at the clamped ids, -0.0 for padding ids."""
    idx, valid = _gather_index(ids, param.shape[0])
    delta = -(lr.reshape(()).float() * rows.float())
    return param.index_add_(0, idx, torch.where(valid[:, None], delta, -0.0)
                            .to(param.dtype))
