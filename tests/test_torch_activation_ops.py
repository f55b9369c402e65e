"""The port's activation table, ``sum`` and ``sign`` match the JAX package's.

Each op of ``paddle_tpu/ops/activation_ops.py`` runs through each
package's registered implementation on the same ``RandomState`` input
(float32, [4, 6, 3, 5], drawn away from the op's kinks and inside its
domain), and its gradient against one random cotangent through each
package's autodiff (``jax.vjp``, ``torch.autograd.grad``): outputs to
1e-6 and gradients to 1e-5 (relative, with as much absolute slack at
values near 0). At the kinks the two packages must take the same
subgradient, exactly (``test_kinks_take_jax_subgradients``).

``sum`` adds a list of tensors and may write one of its own inputs; with
``sign`` it makes Fluid's weight decay: a 2-layer MLP under
``Momentum(0.1, 0.9, regularization=L2Decay(1e-4))`` (and ``L1Decay``)
trains 3 steps in both packages from the JAX startup state, carried by
``io.state_from_numpy``: losses to 1e-6 relative and every persistable
to 1e-6 norm-wise. The same program through ``Executor.run_steps`` (the
captured step's body, step by step on the CPU) equals ``run()``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg

SHAPE = (4, 6, 3, 5)

# op type -> (attrs, kinks the input keeps away from, domain)
CASES = {
    "sigmoid": ({}, (), "real"),
    "logsigmoid": ({}, (), "real"),
    "exp": ({}, (), "real"),
    "tanh_shrink": ({}, (), "real"),
    "sqrt": ({}, (), "positive"),
    "rsqrt": ({}, (), "positive"),
    "abs": ({}, (0.0,), "real"),
    "ceil": ({}, (), "real"),
    "floor": ({}, (), "real"),
    "cos": ({}, (), "real"),
    "sin": ({}, (), "real"),
    "round": ({}, (), "real"),
    "reciprocal": ({}, (), "positive"),
    "log": ({}, (), "positive"),
    "softplus": ({}, (), "real"),
    "softsign": ({}, (0.0,), "real"),
    "relu": ({}, (0.0,), "real"),
    "tanh": ({}, (), "real"),
    "square": ({}, (), "real"),
    "leaky_relu": ({"alpha": 0.1}, (0.0,), "real"),
    "relu6": ({"threshold": 2.0}, (0.0, 2.0), "real"),
    "pow": ({"factor": 2.5}, (), "positive"),
    "stanh": ({"scale_a": 0.67, "scale_b": 1.7159}, (), "real"),
    "hard_sigmoid": ({"slope": 0.2, "offset": 0.5}, (-2.5, 2.5), "real"),
    "swish": ({"beta": 1.5}, (), "real"),
    "elu": ({"alpha": 0.7}, (0.0,), "real"),
    "selu": ({}, (0.0,), "real"),
    "brelu": ({"t_min": -1.0, "t_max": 1.5}, (-1.0, 1.5), "real"),
    "soft_relu": ({"threshold": 2.0}, (-2.0, 2.0), "real"),
    "hard_shrink": ({"threshold": 0.5}, (-0.5, 0.5), "real"),
    "soft_shrink": ({"lambda": 0.4}, (-0.4, 0.4), "real"),
    "softshrink": ({"lambda": 0.4}, (-0.4, 0.4), "real"),
    "thresholded_relu": ({"threshold": 0.3}, (0.3,), "real"),
    "maxout": ({"groups": 3}, (), "real"),
    "log1p": ({}, (), "positive"),
    "erf": ({}, (), "real"),
    "gelu": ({"approximate": False}, (), "real"),
    "sign": ({}, (0.0,), "real"),
}
PRELU_MODES = {"all": (1,), "channel": (SHAPE[1],), "element": SHAPE[1:]}


def draw(kinks, domain, seed=0):
    """randn·2 with every value within 0.05 of a kink (and of a
    half-integer, where ``round`` ties) moved 0.1 off it; ``positive``
    takes |x| + 0.1."""
    x = np.random.RandomState(seed).randn(*SHAPE).astype(np.float32) * 2
    if domain == "positive":
        return np.abs(x) + 0.1
    for k in kinks:
        x = np.where(np.abs(x - k) < 0.05, k + 0.1, x).astype(np.float32)
    frac = np.abs(x - np.round(x))
    return np.where(np.abs(frac - 0.5) < 0.05, x + 0.1, x).astype(np.float32)


def fake_op(op_type, attrs, inputs):
    return types.SimpleNamespace(
        type=op_type, attrs=dict(attrs), block=None,
        inputs={k: [k] for k in inputs}, outputs={"Out": ["Out"]})


def run_jax(op_type, attrs, inputs, cot):
    """(out, {slot: grad}) of the JAX package's op."""
    names = sorted(inputs)

    def f(*vals):
        env = dict(zip(names, vals))
        trace = types.SimpleNamespace(is_test=False)
        jreg.get_op_impl(op_type)(
            jreg.OpContext(fake_op(op_type, attrs, names), env, trace))
        return env["Out"]

    out, vjp = jax.vjp(f, *[jnp.asarray(inputs[n]) for n in names])
    grads = vjp(jnp.asarray(cot.reshape(out.shape)))
    return np.asarray(out), {n: np.asarray(g) for n, g in zip(names, grads)}


def run_port(op_type, attrs, inputs, cot):
    """(out, {slot: grad}) of the port's op."""
    names = sorted(inputs)
    env = {n: torch.tensor(inputs[n], requires_grad=True) for n in names}
    leaves = [env[n] for n in names]
    trace = types.SimpleNamespace(is_test=False)
    treg.get_op_impl(op_type)(
        treg.OpContext(fake_op(op_type, attrs, names), env, trace))
    out = env["Out"]
    grads = torch.autograd.grad(out, leaves,
                                torch.tensor(cot.reshape(out.shape)),
                                allow_unused=True)
    return out.detach().numpy(), {
        n: np.zeros_like(inputs[n]) if g is None else g.numpy()
        for n, g in zip(names, grads)}


def cotangent(op_type, attrs, x):
    env = {"X": torch.tensor(x)}
    treg.get_op_impl(op_type)(treg.OpContext(
        fake_op(op_type, attrs, ["X"]), env, None))
    return np.random.RandomState(1).randn(env["Out"].numel()).astype(
        np.float32)


@pytest.mark.parametrize("op_type", sorted(CASES))
def test_op_matches_jax(op_type):
    attrs, kinks, domain = CASES[op_type]
    x = draw(kinks, domain)
    cot = cotangent(op_type, attrs, x)
    want, want_g = run_jax(op_type, attrs, {"X": x}, cot)
    got, got_g = run_port(op_type, attrs, {"X": x}, cot)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_g["X"], want_g["X"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", sorted(PRELU_MODES))
def test_prelu_matches_jax(mode):
    x = draw((0.0,), "real")
    alpha = np.random.RandomState(2).rand(*PRELU_MODES[mode]).astype(
        np.float32)
    inputs = {"X": x, "Alpha": alpha}
    cot = np.random.RandomState(1).randn(x.size).astype(np.float32)
    want, want_g = run_jax("prelu", {"mode": mode}, inputs, cot)
    got, got_g = run_port("prelu", {"mode": mode}, inputs, cot)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for slot in inputs:
        np.testing.assert_allclose(got_g[slot], want_g[slot], rtol=1e-5,
                                   atol=1e-5, err_msg=slot)


# each op at its kinks (and beside them), where JAX's autodiff picks one
# subgradient: jnp.clip gives half the gradient at a bound, x >= 0 takes
# the gradient 1 at 0, strict comparisons 0 at the threshold
KINKS = {
    "relu": ({}, [0.0]),
    "relu6": ({"threshold": 6.0}, [0.0, 6.0]),
    "brelu": ({"t_min": 0.0, "t_max": 24.0}, [0.0, 24.0]),
    "hard_sigmoid": ({"slope": 0.2, "offset": 0.5}, [-2.5, 2.5]),
    "soft_relu": ({"threshold": 2.0}, [-2.0, 2.0]),
    "leaky_relu": ({"alpha": 0.02}, [0.0]),
    "abs": ({}, [0.0]),
    "elu": ({"alpha": 0.7}, [0.0]),
    "selu": ({}, [0.0]),
    "hard_shrink": ({"threshold": 0.5}, [-0.5, 0.5]),
    "soft_shrink": ({"lambda": 0.5}, [-0.5, 0.5]),
    "thresholded_relu": ({"threshold": 1.0}, [1.0]),
    "round": ({}, [0.5, 1.5, -0.5, 2.0]),
    "floor": ({}, [1.0, -1.0, 0.0]),
    "ceil": ({}, [1.0, -1.0, 0.0]),
    "sign": ({}, [0.0]),
    "softsign": ({}, [0.0]),
}


@pytest.mark.parametrize("op_type", sorted(KINKS))
def test_kinks_take_jax_subgradients(op_type):
    attrs, kinks = KINKS[op_type]
    x = np.array([k + d for k in kinks for d in (-1e-3, 0.0, 1e-3)],
                 np.float32)
    cot = np.ones(x.size, np.float32)
    want, want_g = run_jax(op_type, attrs, {"X": x}, cot)
    got, got_g = run_port(op_type, attrs, {"X": x}, cot)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got_g["X"], want_g["X"])


def test_maxout_splits_a_tie_as_jax_does():
    x = np.ones((1, 4, 1, 2), np.float32)
    cot = np.ones(4, np.float32)
    want, want_g = run_jax("maxout", {"groups": 2}, {"X": x}, cot)
    got, got_g = run_port("maxout", {"groups": 2}, {"X": x}, cot)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_g["X"], want_g["X"])
    assert float(got_g["X"].max()) == 0.5


def test_sum_of_three_writes_its_first_input():
    """``Out`` = ``X[0]``, as the weight decay writes ``grad``."""
    rng = np.random.RandomState(0)
    xs = [rng.randn(3, 5).astype(np.float32) for _ in range(3)]
    for reg, get_impl, tensor in (
            (jreg, jreg.get_op_impl, jnp.asarray),
            (treg, treg.get_op_impl, torch.tensor)):
        op = types.SimpleNamespace(type="sum", attrs={}, block=None,
                                   inputs={"X": ["a", "b", "c"]},
                                   outputs={"Out": ["a"]})
        env = {n: tensor(x) for n, x in zip("abc", xs)}
        get_impl("sum")(reg.OpContext(op, env, None))
        np.testing.assert_allclose(np.asarray(env["a"]),
                                   xs[0] + xs[1] + xs[2], rtol=1e-6)


def build_mlp(fluid, reg):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[16])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 32, act="sigmoid")
        logits = fluid.layers.fc(h, 4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        decay = getattr(fluid.regularizer, reg)(1e-4)
        fluid.optimizer.Momentum(0.1, 0.9,
                                 regularization=decay).minimize(loss)
    return main, startup, loss


def mlp_feed():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(8, 16).astype("float32"),
            "y": rng.randint(0, 4, (8, 1)).astype("int64")}


@pytest.mark.parametrize("reg", ["L2Decay", "L1Decay"])
def test_weight_decay_mlp_matches_jax(reg):
    jm, js, jl = build_mlp(jfluid, reg)
    tm, _, tl = build_mlp(tfluid, reg)
    ops = [op.type for op in tm.global_block.ops]
    assert ops == [op.type for op in jm.global_block.ops]
    assert ops.count("sum") == 4
    assert ops.count("sign") == (4 if reg == "L1Decay" else 0)
    feed = mlp_feed()
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
        want = [float(jexe.run(jm, feed=feed, fetch_list=[jl])[0])
                for _ in range(3)]
    tscope = tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(),
                                        tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = [float(texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)[0])
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for n in arrays:
        a = np.asarray(jscope.find_var(n), np.float64)
        err = np.linalg.norm(tscope.as_numpy(n) - a) / max(
            np.linalg.norm(a), 1e-30)
        assert err <= 1e-6, (n, err)


def test_weight_decay_run_steps_equals_run():
    """``sum`` writing ``grad`` in place inside the captured step's body."""
    main, startup, loss = build_mlp(tfluid, "L2Decay")
    feed = mlp_feed()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    arrays = {n: scope.as_numpy(n) for n in scope.vars}
    want = [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0]) for _ in range(4)]
    main._tpu_step_counter = 0
    other = tfluid.io.state_from_numpy(main, arrays, tfluid.Scope(),
                                       tfluid.CPUPlace())
    got = [float(r[0]) for r in exe.run_steps(
        main, [feed] * 4, fetch_list=[loss], fetch_every=4, scope=other)]
    assert got == want
    for n in arrays:
        np.testing.assert_array_equal(other.as_numpy(n), scope.as_numpy(n))
