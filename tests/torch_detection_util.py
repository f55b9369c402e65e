"""Shared harness of the detection tests: one op through each package's
registered implementation on the same ``RandomState`` inputs, outputs
and gradients compared (float to 1e-5, discrete outputs exactly)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu  # noqa: F401  (registers the JAX package's ops)
import paddle_tpu_torch  # noqa: F401
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg
from test_torch_dense_reduce_math import (_dtype_name, _flat, _is_float, _np,
                                          _out_names, _torch, fake_op)

TOL = (1e-5, 1e-5)


class JaxTrace:
    """The JAX op's context: train mode and one fixed key."""

    is_test = False

    def op_rng(self, ctx):
        return jax.random.PRNGKey(0)


def port_trace(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return types.SimpleNamespace(is_test=False, program=None,
                                 device=torch.device("cpu"),
                                 op_rng=lambda ctx: gen)


def _jax_fn(op_type, attrs, inputs, outs, names):
    """The JAX op as a function of the inputs ``names`` → its outputs."""
    flat = _flat(inputs)
    out_names = [n for ns in _out_names(outs).values() for n in ns]

    def f(*vals):
        env = {n: jnp.asarray(v) for n, v in flat.items()}
        env.update(zip(names, vals))
        jreg.get_op_impl(op_type)(jreg.OpContext(
            fake_op(op_type, attrs, inputs, outs), env, JaxTrace()))
        return {n: env[n] for n in out_names if n in env}

    return f


def run_jax(op_type, attrs, inputs, outs):
    """The JAX op's outputs, jitted as a whole (one compile, not one a
    primitive)."""
    flat = _flat(inputs)
    names = sorted(flat)
    f = jax.jit(_jax_fn(op_type, attrs, inputs, outs, names))
    return {n: np.asarray(v) for n, v in
            f(*[jnp.asarray(flat[n]) for n in names]).items()}


def run_port(op_type, attrs, inputs, outs, diff=(), seed=0):
    flat = _flat(inputs)
    env = {n: _torch(v) for n, v in flat.items()}
    for n in diff:
        env[n].requires_grad_(True)
    treg.get_op_impl(op_type)(treg.OpContext(
        fake_op(op_type, attrs, inputs, outs), env, port_trace(seed)))
    return env, {n: env[n] for ns in _out_names(outs).values()
                 for n in ns if n in env}


def check_det(op_type, attrs, inputs, outs, diff=None, tol=TOL,
              grad_tol=TOL, cot_seed=1):
    """Runs ``op_type`` through both packages: every output (float ones
    to ``tol``, the others exactly, dtypes equal) and, for the float
    inputs (or ``diff``), the gradient of the float outputs against one
    random cotangent. Returns the port's outputs."""
    flat = _flat(inputs)
    if diff is None:
        diff = [n for n, v in flat.items() if _is_float(v)]
    want = run_jax(op_type, attrs, inputs, outs)
    env, got = run_port(op_type, attrs, inputs, outs, diff)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for n in want:
        w, g = want[n], got[n]
        # JAX without x64 holds an int64 input as int32
        assert _dtype_name(g) == _dtype_name(w) or (
            _dtype_name(g), _dtype_name(w)) == ("int64", "int32"), (
                n, _dtype_name(g), _dtype_name(w))
        assert tuple(g.shape) == w.shape, (n, tuple(g.shape), w.shape)
        if _is_float(w):
            np.testing.assert_allclose(_np(g), w, rtol=tol[0], atol=tol[1],
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(_np(g), w, err_msg=n)
    fouts = [n for n in want if _is_float(want[n]) and got[n].requires_grad]
    if diff and fouts:
        rng = np.random.RandomState(cot_seed)
        cots = {n: rng.randn(*want[n].shape).astype(np.float32) for n in fouts}

        fn = _jax_fn(op_type, attrs, inputs, outs, diff)

        @jax.jit
        def grads(*vals):
            _, vjp = jax.vjp(lambda *v: [fn(*v)[n] for n in fouts], *vals)
            return vjp([jnp.asarray(cots[n]) for n in fouts])

        want_g = grads(*[jnp.asarray(flat[n]) for n in diff])
        got_g = torch.autograd.grad([got[n] for n in fouts],
                                    [env[n] for n in diff],
                                    [torch.tensor(cots[n]) for n in fouts],
                                    allow_unused=True)
        for n, w, g in zip(diff, want_g, got_g):
            g = torch.zeros(np.shape(w)) if g is None else g
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=grad_tol[0],
                                       atol=grad_tol[1], err_msg="grad " + n)
    return got


def boxes(rng, n, lead=(), lo=0.0, hi=1.0, min_wh=0.02):
    """[*lead, n, 4] xyxy boxes inside [lo, hi]."""
    p = rng.uniform(lo, hi, lead + (n, 2, 2))
    a, b = p.min(-2), p.max(-2)
    b = np.maximum(b, a + min_wh * (hi - lo))
    return np.concatenate([a, b], -1).astype(np.float32)
