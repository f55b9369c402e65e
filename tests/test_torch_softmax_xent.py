"""The port's fused softmax cross-entropy against the JAX package.

On the CPU the wrapper takes its plain version (``softmax_xent_reference``
and ``softmax_xent_reference_bwd``). It is held against the JAX Pallas
kernel pair run by the Pallas interpreter (``fused_softmax_xent(...,
interpret=True)``), loss and gradient, in float32 to 1e-6 (same math,
another summation order) and with bfloat16 logits to 2e-2 (bf16 rounding
of the gradient). In float32 each side is first held, at the same 1e-6, to
the loss and gradient computed by numpy in float64 from the same inputs,
so that a side that moves is named by the assertion that fails. Rows
labelled ``ignore_index`` are held against the JAX
op's composed ``_hard_label_xent``, which zeroes their loss and gradient.
The CUDA kernels themselves are held against the plain version on the card
by ``test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import nn_ops as jnn
from paddle_tpu.ops.pallas_kernels import fused_softmax_xent
from paddle_tpu_torch.ops.kernels import softmax_xent as tsx

SHAPES = [(16, 300), (40, 1000)]


def make(n, v, seed, ignore_rows=()):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, v) * 3).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int64)
    labels[list(ignore_rows)] = -100
    g = rng.randn(n, 1).astype(np.float32)  # non-uniform cotangent
    return logits, labels, g


def jax_pallas(logits, labels, g, smooth, dtype):
    x = jnp.asarray(logits).astype(dtype)
    lab = jnp.asarray(labels.astype(np.int32)[:, None])
    loss, vjp = jax.vjp(lambda z: fused_softmax_xent(z, lab, True, smooth), x)
    (dx,) = vjp(jnp.asarray(g))
    return (np.asarray(loss, np.float32),
            np.asarray(dx.astype(jnp.float32)))


def float64_truth(logits, labels, g, smooth):
    """Loss [N,1] and dlogits [N,V] of the module docstring's formulas, by
    numpy in float64 from the float32 inputs."""
    x = logits.astype(np.float64)
    n, v = x.shape
    m = x.max(axis=-1, keepdims=True)
    lse = m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))
    onehot = np.zeros_like(x)
    onehot[np.arange(n), labels] = 1.0
    loss = lse - (1 - smooth) * (x * onehot).sum(-1, keepdims=True) \
        - (smooth / v) * x.sum(-1, keepdims=True)
    dx = g.astype(np.float64) * (np.exp(x - lse) - (1 - smooth) * onehot
                                 - smooth / v)
    return loss, dx


def port(logits, labels, g, smooth, dtype, ignore_index=-100):
    x = torch.as_tensor(logits).to(dtype)
    lab = torch.as_tensor(labels)
    loss, lse = tsx.softmax_xent_reference(x, lab, smooth, ignore_index)
    dx = tsx.softmax_xent_reference_bwd(x, lab, lse, torch.as_tensor(g),
                                        smooth, ignore_index)
    assert loss.dtype == torch.float32 and dx.dtype == dtype
    return loss.numpy(), dx.float().numpy()


@pytest.mark.parametrize("n,v", SHAPES)
@pytest.mark.parametrize("smooth", [0.0, 0.1])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 2e-2)])
def test_plain_version_matches_pallas_interpreter(n, v, smooth, dtype, tol):
    logits, labels, g = make(n, v, seed=n + v)
    want_loss, want_dx = jax_pallas(logits, labels, g, smooth,
                                    getattr(jnp, dtype))
    got_loss, got_dx = port(logits, labels, g, smooth,
                            getattr(torch, dtype))
    if dtype == "float32":
        true_loss, true_dx = float64_truth(logits, labels, g, smooth)
        for side, loss, dx in (("port", got_loss, got_dx),
                               ("pallas", want_loss, want_dx)):
            np.testing.assert_allclose(loss, true_loss, rtol=tol, atol=tol,
                                       err_msg=side + " loss vs float64")
            np.testing.assert_allclose(dx, true_dx, rtol=tol, atol=tol,
                                       err_msg=side + " dlogits vs float64")
    np.testing.assert_allclose(got_loss, want_loss, rtol=tol, atol=tol)
    np.testing.assert_allclose(got_dx, want_dx, rtol=tol, atol=tol)


@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_ignored_rows_match_composed_hard_label_xent(smooth):
    n, v = 24, 300
    ignore = (0, 5, 23)
    logits, labels, g = make(n, v, seed=3, ignore_rows=ignore)
    lab32 = jnp.asarray(labels.astype(np.int32))
    loss, vjp = jax.vjp(
        lambda z: jnn._hard_label_xent(z, lab32, smooth, -100),
        jnp.asarray(logits))
    (dx,) = vjp(jnp.asarray(g))
    got_loss, got_dx = port(logits, labels, g, smooth, torch.float32)
    np.testing.assert_allclose(got_loss, np.asarray(loss), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_dx, np.asarray(dx), rtol=1e-6, atol=1e-6)
    assert not got_loss[list(ignore)].any()
    assert not got_dx[list(ignore)].any()


def test_autograd_function_on_cpu_tensors():
    n, v, smooth = 16, 300, 0.1
    logits, labels, g = make(n, v, seed=5, ignore_rows=(2,))
    x = torch.as_tensor(logits).requires_grad_(True)
    lab = torch.as_tensor(labels)
    loss = tsx.softmax_xent(x, lab, smooth)
    (dx,) = torch.autograd.grad(loss, [x], torch.as_tensor(g))
    want_loss, want_dx = port(logits, labels, g, smooth, torch.float32)
    np.testing.assert_array_equal(loss.detach().numpy(), want_loss)
    np.testing.assert_array_equal(dx.numpy(), want_dx)


def test_wrapper_device_rule_and_launch_counts():
    logits, labels, g = make(8, 50, seed=7)
    fwd0, bwd0 = tsx.LAUNCHES_FWD, tsx.LAUNCHES_BWD
    x = torch.as_tensor(logits).requires_grad_(True)
    loss = tsx.softmax_xent(x, torch.as_tensor(labels), 0.1)
    torch.autograd.grad(loss.sum(), [x])
    assert (tsx.LAUNCHES_FWD, tsx.LAUNCHES_BWD) == (fwd0, bwd0)
    meta = torch.empty(8, 50, device="meta")
    meta_lab = torch.empty(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tsx.softmax_xent_fwd(meta, meta_lab)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tsx.softmax_xent_bwd(meta, meta_lab, torch.empty(8, 1, device="meta"),
                             torch.empty(8, 1, device="meta"))
    with pytest.raises(TypeError, match="int64"):
        tsx.softmax_xent_fwd(x, torch.as_tensor(labels.astype(np.int32)))
    with pytest.raises(ValueError, match="labels must be"):
        tsx.softmax_xent_fwd(x, torch.as_tensor(labels[:4]))
