"""The port's 3-D and transposed convolutions and 3-D pooling match the
JAX package's.

Each op runs through each package's registered implementation on the
same ``RandomState`` inputs, forward and, against one random cotangent,
the gradients of the input and the filter (``jax.vjp``,
``torch.autograd.grad``), all in float32:

* ``conv3d`` (groups 1 and 2), ``conv2d_transpose`` and
  ``conv3d_transpose`` (groups 1; strides, paddings, dilations) against
  the JAX package: output and gradients to 1e-5 norm-wise (sums of up to a
  few hundred products, accumulated in another order);
* ``conv2d_transpose`` / ``depthwise_conv2d_transpose`` with groups > 1,
  which the JAX package cannot run (it swaps the filter to [C_out/g, C_in,
  k, k] before ``feature_group_count``; a test pins that it raises),
  against a float64 truth: each group's ``groups=1`` transpose of its own
  input channels and filter rows, concatenated, gradients by float64
  autograd of that; to 1e-5 norm-wise;
* ``pool3d`` max and avg, ``global_pooling``, ``adaptive`` (divisible and
  ragged windows), ``exclusive`` averaging over padding and windows wider
  than twice their padding: output and input gradient to 1e-6 norm-wise
  (no tie in the random inputs).

Then a small 3-D program built by both packages with ``layers.conv3d``,
``pool3d`` and ``conv2d_transpose`` trains 3 SGD steps from the JAX
startup state: the programs equal op for op, losses to 1e-5 and every
parameter to 1e-5 norm-wise.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg

CONV_SLOTS = ("Input", "Filter")


def fake_op(op_type, attrs, slots, out_slot):
    return types.SimpleNamespace(
        type=op_type, attrs=dict(attrs), block=None,
        inputs={k: [k] for k in slots}, outputs={out_slot: ["out"]})


def run_jax(op_type, attrs, inputs, out_slot, seed=1):
    """(out, {slot: grad}) of the JAX package's op."""
    names = sorted(inputs)

    def f(*vals):
        env = dict(zip(names, vals))
        jreg.get_op_impl(op_type)(jreg.OpContext(
            fake_op(op_type, attrs, names, out_slot), env,
            types.SimpleNamespace(is_test=False)))
        return env["out"]

    out, vjp = jax.vjp(f, *[jnp.asarray(inputs[n]) for n in names])
    cot = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    grads = vjp(jnp.asarray(cot))
    return np.asarray(out), {n: np.asarray(g) for n, g in zip(names, grads)}


def run_port(op_type, attrs, inputs, out_slot, seed=1):
    """(out, {slot: grad}) of the port's op."""
    names = sorted(inputs)
    env = {n: torch.tensor(inputs[n], requires_grad=True) for n in names}
    leaves = [env[n] for n in names]
    treg.get_op_impl(op_type)(treg.OpContext(
        fake_op(op_type, attrs, names, out_slot), env,
        types.SimpleNamespace(is_test=False)))
    out = env["out"]
    cot = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    grads = torch.autograd.grad(out, leaves, torch.tensor(cot))
    return out.detach().numpy(), {n: g.numpy() for n, g in zip(names, grads)}


def norm_err(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def conv_attrs(nd, stride, pad, dil, groups):
    return {"strides": [stride] * nd, "paddings": [pad] * nd,
            "dilations": [dil] * nd, "groups": groups}


def transpose_size(h, k, s, p, d):
    return (h - 1) * s - 2 * p + d * (k - 1) + 1


# (op, nd, C_in, C_out, spatial, k, stride, pad, dilation, groups)
AGAINST_JAX = [
    ("conv3d", 3, 4, 6, 6, 3, 1, 1, 1, 1),
    ("conv3d", 3, 4, 6, 7, 3, 2, 0, 1, 2),
    ("conv3d", 3, 3, 4, 6, 2, 1, 1, 2, 1),
    ("conv2d_transpose", 2, 6, 4, 5, 5, 2, 2, 1, 1),
    ("conv2d_transpose", 2, 3, 5, 4, 4, 2, 1, 1, 1),
    ("conv2d_transpose", 2, 4, 3, 5, 3, 1, 0, 2, 1),
    ("conv3d_transpose", 3, 4, 3, 4, 2, 2, 0, 1, 1),
    ("conv3d_transpose", 3, 3, 2, 3, 3, 2, 1, 1, 1),
]


def conv_inputs(op, nd, ci, co, hw, k, groups, seed=0):
    x = randn(seed, 2, ci, *([hw] * nd))
    shape = [ci, co // groups] if "transpose" in op else [co, ci // groups]
    w = randn(seed + 1, *(shape + [k] * nd)) * 0.3
    return {"Input": x, "Filter": w}


@pytest.mark.parametrize("case", AGAINST_JAX, ids=lambda c: "-".join(
    map(str, c)))
def test_conv_matches_jax(case):
    op, nd, ci, co, hw, k, s, p, d, g = case
    inputs = conv_inputs(op, nd, ci, co, hw, k, g)
    attrs = conv_attrs(nd, s, p, d, g)
    want, want_g = run_jax(op, attrs, inputs, "Output")
    got, got_g = run_port(op, attrs, inputs, "Output")
    assert got.shape == want.shape
    if "transpose" in op:
        assert got.shape[2:] == (transpose_size(hw, k, s, p, d),) * nd
    assert norm_err(got, want) <= 1e-5
    for slot in CONV_SLOTS:
        assert norm_err(got_g[slot], want_g[slot]) <= 1e-5, slot


def grouped_transpose_f64(x, w, stride, pad, dil, groups):
    """The float64 truth of a grouped 2-D transposed convolution: each
    group's groups=1 transpose, concatenated along the channels."""
    xs = torch.chunk(x, groups, dim=1)
    ws = torch.chunk(w, groups, dim=0)
    return torch.cat([F.conv_transpose2d(xg, wg, None, stride, pad, 0, 1,
                                         dil) for xg, wg in zip(xs, ws)], 1)


# (op, C_in, C_out, spatial, k, stride, pad, dilation, groups)
GROUPED = [
    ("conv2d_transpose", 4, 6, 5, 3, 2, 1, 1, 2),
    ("conv2d_transpose", 8, 4, 4, 4, 2, 1, 1, 4),
    ("conv2d_transpose", 6, 9, 4, 3, 1, 0, 2, 3),
    ("depthwise_conv2d_transpose", 6, 6, 5, 4, 2, 1, 1, 6),
]


@pytest.mark.parametrize("case", GROUPED, ids=lambda c: "-".join(
    map(str, c)))
def test_grouped_transpose_matches_float64_truth(case):
    op, ci, co, hw, k, s, p, d, g = case
    inputs = conv_inputs(op, 2, ci, co, hw, k, g)
    got, got_g = run_port(op, conv_attrs(2, s, p, d, g), inputs, "Output")
    x64, w64 = (torch.tensor(inputs[n], dtype=torch.float64,
                             requires_grad=True) for n in CONV_SLOTS)
    want = grouped_transpose_f64(x64, w64, s, p, d, g)
    cot = torch.tensor(randn(1, *want.shape), dtype=torch.float64)
    want_g = torch.autograd.grad(want, [x64, w64], cot)
    assert got.shape == tuple(want.shape)
    assert got.shape[1] == co
    assert norm_err(got, want.detach()) <= 1e-5
    for slot, wg in zip(CONV_SLOTS, want_g):
        assert norm_err(got_g[slot], wg) <= 1e-5, slot


@pytest.mark.parametrize("op,groups", [("conv2d_transpose", 2),
                                       ("conv2d_transpose", 4),
                                       ("depthwise_conv2d_transpose", 8)])
def test_reference_cannot_run_grouped_transpose(op, groups):
    """The JAX package's grouped transpose feeds a [C_out/g, C_in, k, k]
    filter to ``feature_group_count=groups``, which XLA refuses."""
    inputs = conv_inputs(op, 2, 8, 8, 4, 3, groups)
    with pytest.raises(Exception, match="feature_group_count"):
        run_jax(op, conv_attrs(2, 2, 1, 1, groups), inputs, "Output")


POOLS = {
    "max": {"pooling_type": "max", "ksize": [2, 2, 2],
            "strides": [2, 2, 2], "paddings": [0, 0, 0]},
    "avg": {"pooling_type": "avg", "ksize": [2, 2, 2],
            "strides": [2, 2, 2], "paddings": [0, 0, 0]},
    "max_pad": {"pooling_type": "max", "ksize": [3, 3, 3],
                "strides": [2, 2, 2], "paddings": [1, 1, 1]},
    "avg_exclusive": {"pooling_type": "avg", "ksize": [3, 3, 3],
                      "strides": [2, 1, 2], "paddings": [1, 1, 1],
                      "exclusive": True},
    "avg_inclusive": {"pooling_type": "avg", "ksize": [3, 3, 3],
                      "strides": [2, 2, 2], "paddings": [1, 0, 1],
                      "exclusive": False},
    "avg_wide_pad": {"pooling_type": "avg", "ksize": [2, 3, 2],
                     "strides": [1, 2, 1], "paddings": [1, 2, 1],
                     "exclusive": True},
    "max_wide_pad": {"pooling_type": "max", "ksize": [2, 2, 3],
                     "strides": [1, 1, 2], "paddings": [1, 1, 2]},
    "max_ceil_mode": {"pooling_type": "max", "ksize": [2, 2, 2],
                      "strides": [2, 2, 2], "paddings": [0, 0, 0],
                      "ceil_mode": True},
    "global_max": {"pooling_type": "max", "ksize": [1, 1, 1],
                   "global_pooling": True},
    "global_avg": {"pooling_type": "avg", "ksize": [1, 1, 1],
                   "global_pooling": True},
    "adaptive_avg": {"pooling_type": "avg", "ksize": [3, 2, 3],
                     "adaptive": True},
    "adaptive_max": {"pooling_type": "max", "ksize": [2, 3, 2],
                     "adaptive": True},
}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_pool3d_matches_jax(name):
    x = {"X": randn(3, 2, 3, 6, 5, 7)}
    want, want_g = run_jax("pool3d", POOLS[name], x, "Out")
    got, got_g = run_port("pool3d", POOLS[name], x, "Out")
    assert got.shape == want.shape
    assert norm_err(got, want) <= 1e-6
    assert norm_err(got_g["X"], want_g["X"]) <= 1e-6


def build_3d(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        vol = fluid.layers.data("vol", shape=[2, 6, 8, 8])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        c = fluid.layers.conv3d(vol, 4, 3, padding=1, act="relu")
        c = fluid.layers.pool3d(c, 2, "max", 2)
        img = fluid.layers.reshape(c, [0, 12, 4, 4])
        up = fluid.layers.conv2d_transpose(img, 3, filter_size=4, stride=2,
                                           padding=1, act="sigmoid")
        logits = fluid.layers.fc(up, 5)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.SGD(0.05).minimize(loss)
    return main, startup, loss


def test_3d_program_trains_as_jax_does():
    jm, js, jl = build_3d(jfluid)
    tm, _, tl = build_3d(tfluid)
    assert [op.type for op in tm.global_block.ops] == \
        [op.type for op in jm.global_block.ops]
    assert [(v.name, tuple(v.shape)) for v in tm.list_vars()] == \
        [(v.name, tuple(v.shape)) for v in jm.list_vars()]
    rng = np.random.RandomState(0)
    feed = {"vol": rng.randn(4, 2, 6, 8, 8).astype("float32"),
            "label": rng.randint(0, 5, (4, 1)).astype("int64")}
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
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    for p in tm.all_parameters():
        assert norm_err(tscope.as_numpy(p.name),
                        np.asarray(jscope.find_var(p.name))) <= 1e-5, p.name
