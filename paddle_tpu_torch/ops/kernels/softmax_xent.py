# ported from paddle_tpu/ops/pallas_kernels/softmax_xent.py
"""Fused softmax cross-entropy over hard labels: the CUDA kernel pair and
its plain version.

With a 30k vocabulary the [N, V] logits are the largest tensor of a
Transformer training step. The composed loss materialises [N, V]
log-probabilities forward and reads them back in the backward; the kernels
(``paddle_tpu_torch/csrc/softmax_xent.cu``) read the logits once forward
(K2a, writing only the O(N) loss and logsumexp) and once backward (K2b,
writing dlogits), computing softmax − onehot on the fly.

Per row, with ε = ``smooth`` and lse = logsumexp(x):

* loss = lse − (1−ε)·x[label] − (ε/V)·Σx   (K2a; 0 where label == ignore_index)
* dlogits = g·(exp(x − lse) − (1−ε)·onehot − ε/V)   (K2b; 0 where ignored)

Rows whose label is ``ignore_index`` get a zero loss and a zero gradient,
as the JAX op's composed path computes them on every device (the JAX Pallas
kernel masks nothing; the JAX op only takes it at ignore_index = -100).
Other labels outside [0, V) are clamped to the vocabulary.

:func:`softmax_xent` is the autograd-aware entry point
(:class:`SoftmaxXent`), which also gives shape inference its empty
``meta`` output. :func:`softmax_xent_fwd` / :func:`softmax_xent_bwd`
take the plain version (:func:`softmax_xent_reference`,
:func:`softmax_xent_reference_bwd`) for tensors on the CPU, and for CUDA
tensors launch the kernel or raise: nothing falls back from a kernel to
the plain version. Every forward launch adds one to :data:`LAUNCHES_FWD`,
every backward launch one to :data:`LAUNCHES_BWD`, and each also adds one
to its shape's entry in :data:`LAUNCHES_BY_SHAPE`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["softmax_xent", "SoftmaxXent", "softmax_xent_fwd",
           "softmax_xent_bwd", "softmax_xent_reference",
           "softmax_xent_reference_bwd", "LAUNCHES_FWD", "LAUNCHES_BWD",
           "LAUNCHES_BY_SHAPE"]

LAUNCHES_FWD = 0  # K2a launches since import (or since a caller reset it)
LAUNCHES_BWD = 0  # K2b launches
# ("K2a" or "K2b", N, V, logits dtype) -> launches; a caller clears it
LAUNCHES_BY_SHAPE: dict = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = None


def _kernels():
    global _fns
    if _fns is None:
        lib = _build.load("softmax_xent")
        fwd, bwd = lib.softmax_xent_fwd, lib.softmax_xent_bwd
        # logits, labels, loss, lse, n, v, smooth, ignore, dtype, stream
        fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                        + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_void_p])
        # logits, labels, lse, g, dlogits, n, v, smooth, ignore, dtype, stream
        bwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                        + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_void_p])
        fwd.restype = bwd.restype = ctypes.c_int
        _fns = (fwd, bwd)
    return _fns


def _check(logits, labels):
    if logits.dim() != 2 or logits.shape[1] < 1:
        raise ValueError("logits must be [N, V], got shape %s"
                         % (tuple(logits.shape),))
    if labels.dim() != 1 or labels.shape[0] != logits.shape[0]:
        raise ValueError("labels must be [%d], got shape %s"
                         % (logits.shape[0], tuple(labels.shape)))
    if logits.dtype not in _DTYPE_CODE:
        raise TypeError("logits must be one of %s, got %s"
                        % (sorted(map(str, _DTYPE_CODE)), logits.dtype))
    if labels.dtype != torch.int64:
        raise TypeError("labels must be int64, got %s" % labels.dtype)
    if logits.device != labels.device:
        raise ValueError("logits on %s, labels on %s"
                         % (logits.device, labels.device))
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError("softmax_xent runs on cuda or cpu, got %s"
                         % logits.device)


def _count_shape(kernel, logits):
    key = (kernel, *logits.shape, logits.dtype)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


def _launch(fn, *args):
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        err = fn(*ptrs, stream)
    if err != 0:
        raise RuntimeError("softmax_xent kernel launch failed: cudaError_t %d"
                           % err)


def softmax_xent_fwd(logits, labels, smooth=0.0, ignore_index=-100):
    """(loss [N,1], lse [N,1]), both float32, of [N,V] float32/bfloat16
    logits and [N] int64 labels: K2a on a CUDA tensor, the plain version
    on a CPU tensor."""
    global LAUNCHES_FWD
    _check(logits, labels)
    if logits.device.type == "cpu":
        return softmax_xent_reference(logits, labels, smooth, ignore_index)
    _build.refuse_export("K2a (softmax_xent_fwd)")
    logits, labels = logits.contiguous(), labels.contiguous()
    n, v = logits.shape
    loss = torch.empty((n, 1), dtype=torch.float32, device=logits.device)
    lse = torch.empty((n, 1), dtype=torch.float32, device=logits.device)
    fwd, _ = _kernels()
    _launch(fwd, logits, labels, loss, lse, n, v, float(smooth),
            int(ignore_index), _DTYPE_CODE[logits.dtype])
    LAUNCHES_FWD += 1
    _count_shape("K2a", logits)
    return loss, lse


def softmax_xent_bwd(logits, labels, lse, g, smooth=0.0, ignore_index=-100):
    """dlogits [N,V] in the logits' dtype for the upstream gradient ``g``
    [N,1] (or [N]) of the loss: K2b on a CUDA tensor, the plain version on
    a CPU tensor."""
    global LAUNCHES_BWD
    _check(logits, labels)
    n, v = logits.shape
    if lse.device != logits.device or g.device != logits.device:
        raise ValueError("lse on %s and g on %s, logits on %s"
                         % (lse.device, g.device, logits.device))
    lse = lse.reshape(n, 1).float()
    g = g.reshape(n, 1).float()
    if logits.device.type == "cpu":
        return softmax_xent_reference_bwd(logits, labels, lse, g, smooth,
                                          ignore_index)
    _build.refuse_export("K2b (softmax_xent_bwd)")
    logits, labels = logits.contiguous(), labels.contiguous()
    lse, g = lse.contiguous(), g.contiguous()
    dlogits = torch.empty_like(logits)
    _, bwd = _kernels()
    _launch(bwd, logits, labels, lse, g, dlogits, n, v, float(smooth),
            int(ignore_index), _DTYPE_CODE[logits.dtype])
    LAUNCHES_BWD += 1
    _count_shape("K2b", logits)
    return dlogits


class SoftmaxXent(torch.autograd.Function):
    """loss [N,1] float32; the backward is K2b (or its plain version)."""

    @staticmethod
    def forward(ctx, logits, labels, smooth, ignore_index):
        loss, lse = softmax_xent_fwd(logits, labels, smooth, ignore_index)
        ctx.save_for_backward(logits, labels, lse)
        ctx.smooth, ctx.ignore_index = smooth, ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        d = softmax_xent_bwd(logits, labels, lse, g, ctx.smooth,
                             ctx.ignore_index)
        return d, None, None, None


def softmax_xent(logits, labels, smooth=0.0, ignore_index=-100):
    """Per-row smoothed cross-entropy [N,1] (float32) of [N,V] logits and
    [N] int64 labels, differentiable in the logits. On the ``meta`` device
    of shape inference it returns an empty loss of that shape."""
    if logits.device.type == "meta":
        return logits.new_empty((logits.shape[0], 1), dtype=torch.float32)
    return SoftmaxXent.apply(logits, labels, float(smooth), int(ignore_index))


def softmax_xent_reference(logits, labels, smooth=0.0, ignore_index=-100):
    """The plain version of K2a: (loss, lse) [N,1] float32, written as the
    JAX package's ``_hard_label_xent_fwd`` (``paddle_tpu/ops/nn_ops.py``)."""
    f = logits.float()
    m = f.max(dim=-1, keepdim=True).values
    lse = m + torch.log(torch.exp(f - m).sum(dim=-1, keepdim=True))
    lbl = labels.clamp(0, f.shape[-1] - 1)[:, None]
    loss = lse - torch.gather(f, -1, lbl)
    if smooth:
        k = f.shape[-1]
        sum_logp = f.sum(dim=-1, keepdim=True) - k * lse
        loss = (1.0 - smooth) * loss + (smooth / k) * (-sum_logp)
    loss = torch.where((labels != ignore_index)[:, None], loss, 0.0)
    return loss, lse


def softmax_xent_reference_bwd(logits, labels, lse, g, smooth=0.0,
                               ignore_index=-100):
    """The plain version of K2b, written as the JAX package's
    ``_hard_label_xent_bwd``: dlogits in the logits' dtype."""
    f = logits.float()
    p = torch.exp(f - lse)
    k = f.shape[-1]
    cols = torch.arange(k, device=f.device)[None, :]
    onehot = (cols == labels.clamp(0, k - 1)[:, None]).float()
    if smooth:
        d = p - (1.0 - smooth) * onehot - (smooth / k)
    else:
        d = p - onehot
    g = torch.where((labels != ignore_index)[:, None], g.float(), 0.0)
    return (g * d).to(logits.dtype)
