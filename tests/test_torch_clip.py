"""The port's gradient clips, comparisons, ``where`` and the math ops they
build match the JAX package's.

The ops (``clip``, ``clip_by_norm`` below and above its norm,
``squared_l2_norm``, ``elementwise_max``/``min``/``pow`` with Fluid's
``axis``, ``increment`` on int64 and float32, the comparisons with Y
cast to X's dtype, the logical ops and ``where``) run through each
package's registered implementation on the same ``RandomState`` inputs:
float32 outputs within 1e-6 relative to their largest magnitude, the
others equal, the shapes equal (``squared_l2_norm`` is 0-d in both).

``GradientClipByValue``, ``GradientClipByNorm`` and
``GradientClipByGlobalNorm`` build the JAX package's op lists, and a
2-layer MLP trains 3 SGD steps under each in both packages from the JAX
startup state, with bounds that clip and bounds that do not (the global
norm below and above ``clip_norm``): losses 1e-5, every persistable
1e-5 norm-wise. Under ``amp.decorate`` the global-norm clip reads the
float32 master gradients only.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg


def fake_op(op_type, inputs, attrs):
    return types.SimpleNamespace(
        type=op_type, attrs=dict(attrs), block=None,
        inputs={k: [k] for k in inputs}, outputs={"Out": ["Out"]})


def run_both(op_type, attrs, inputs):
    jenv = {k: jnp.asarray(v) for k, v in inputs.items()}
    tenv = {k: torch.tensor(v) for k, v in inputs.items()}
    trace = types.SimpleNamespace(is_test=False, device=torch.device("cpu"))
    jreg.get_op_impl(op_type)(jreg.OpContext(
        fake_op(op_type, inputs, attrs), jenv, trace))
    treg.get_op_impl(op_type)(treg.OpContext(
        fake_op(op_type, inputs, attrs), tenv, trace))
    return np.asarray(jenv["Out"]), tenv["Out"].numpy()


def assert_matches(got, want):
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.floating):
        assert got.dtype == want.dtype
        err = np.abs(got.astype(np.float64) - want).max() / max(
            np.abs(want).max(), 1e-30)
        assert err <= 1e-6, (got, want)
    else:
        np.testing.assert_array_equal(got, want)


RNG = np.random.RandomState(0)
X = RNG.randn(4, 6, 5).astype(np.float32)
Y3 = RNG.randn(4, 6, 5).astype(np.float32)
Y_MID = RNG.randn(6).astype(np.float32)
POS = np.abs(RNG.randn(4, 6, 5)).astype(np.float32) + 0.1
EXP = RNG.randn(4, 6, 5).astype(np.float32) * 0.5

MATH = {
    "clip": ({"min": -0.5, "max": 0.7}, {"X": X}),
    "clip_by_norm_clips": ({"max_norm": 1.0}, {"X": X}),
    "clip_by_norm_passes": ({"max_norm": 1e3}, {"X": X}),
    "squared_l2_norm": ({}, {"X": X}),
    "elementwise_max": ({"axis": -1}, {"X": X, "Y": Y3}),
    "elementwise_max_axis": ({"axis": 1}, {"X": X, "Y": Y_MID}),
    "elementwise_min": ({"axis": -1}, {"X": X, "Y": Y3}),
    "elementwise_min_axis": ({"axis": 1}, {"X": X, "Y": Y_MID}),
    "elementwise_pow": ({"axis": -1}, {"X": POS, "Y": EXP}),
    "elementwise_pow_axis": ({"axis": 1}, {"X": POS, "Y": Y_MID}),
    "increment_float": ({"step": 2.5}, {"X": X}),
    "increment_int64": ({"step": 3.0},
                        {"X": np.array([7], np.int64)}),
}


@pytest.mark.parametrize("name", sorted(MATH))
def test_math_op_matches_jax(name):
    attrs, inputs = MATH[name]
    op_type = name.replace("_clips", "").replace("_passes", "").replace(
        "_axis", "").replace("_float", "").replace("_int64", "")
    want, got = run_both(op_type, attrs, inputs)
    if name == "increment_int64":
        # the JAX package's 32-bit mode holds the counter as int32
        assert got.dtype == np.int64 and got.tolist() == [10]
        assert want.tolist() == [10]
        return
    assert_matches(got, want)
    if name == "clip_by_norm_passes":
        np.testing.assert_array_equal(got, X)
    if name == "squared_l2_norm":
        assert got.shape == ()


CMP = ["less_than", "less_equal", "greater_than", "greater_equal", "equal",
       "not_equal"]


@pytest.mark.parametrize("op_type", CMP)
@pytest.mark.parametrize("ydtype", ["float32", "int64"])
def test_comparison_matches_jax(op_type, ydtype):
    x = np.round(RNG.randn(5, 4) * 2).astype(np.float32)
    y = np.round(RNG.randn(5, 4) * 2).astype(ydtype)
    y[0] = x[0].astype(ydtype)  # ties
    want, got = run_both(op_type, {}, {"X": x, "Y": y})
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


@pytest.mark.parametrize("op_type", ["logical_and", "logical_or",
                                     "logical_xor", "logical_not"])
def test_logical_op_matches_jax(op_type):
    rng = np.random.RandomState(1)
    inputs = {"X": rng.rand(5, 4) > 0.5}
    if op_type != "logical_not":
        inputs["Y"] = rng.rand(5, 4) > 0.5
    want, got = run_both(op_type, {}, inputs)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shapes", [((4, 6), (4, 6), (4, 6)),
                                    ((1,), (1,), (1,)),
                                    ((4, 1), (4, 6), (6,))])
def test_where_matches_jax(shapes):
    rng = np.random.RandomState(2)
    cs, xs, ys = shapes
    inputs = {"Condition": rng.rand(*cs) > 0.5,
              "X": rng.randn(*xs).astype(np.float32),
              "Y": rng.randn(*ys).astype(np.float32)}
    want, got = run_both("where", {}, inputs)
    assert_matches(got, want)


def test_where_layer_builds_the_op():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        c = tfluid.layers.data("c", shape=[3], dtype="bool")
        x = tfluid.layers.data("x", shape=[3])
        out = tfluid.layers.where(c, x, tfluid.layers.scale(x, -1.0))
    exe = tfluid.Executor(tfluid.CPUPlace())
    cv = np.array([[True, False, True]])
    xv = np.array([[1.0, 2.0, 3.0]], np.float32)
    got, = exe.run(main, feed={"c": cv, "x": xv}, fetch_list=[out])
    np.testing.assert_array_equal(got, [[1.0, -2.0, 3.0]])


# -- the clips end to end ------------------------------------------------------

CLIPS = {
    "value_clips": lambda f: f.clip.GradientClipByValue(0.01),
    "value_passes": lambda f: f.clip.GradientClipByValue(100.0),
    "norm_clips": lambda f: f.clip.GradientClipByNorm(0.05),
    "norm_passes": lambda f: f.clip.GradientClipByNorm(100.0),
    "global_norm_above": lambda f: f.clip.GradientClipByGlobalNorm(0.05),
    "global_norm_below": lambda f: f.clip.GradientClipByGlobalNorm(100.0),
}


def build_mlp(fluid, make_clip):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[16])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 32, act="sigmoid")
        logits = fluid.layers.fc(h, 4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.clip.set_gradient_clip(make_clip(fluid))
        fluid.optimizer.SGD(0.5).minimize(loss)
    return main, startup, loss


def mlp_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(8, 16).astype("float32"),
            "y": rng.randint(0, 4, (8, 1)).astype("int64")}


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_clip_matches_jax(name):
    jm, js, jl = build_mlp(jfluid, CLIPS[name])
    tm, ts, tl = build_mlp(tfluid, CLIPS[name])
    ops = [op.type for op in tm.global_block.ops]
    assert ops == [op.type for op in jm.global_block.ops]
    kind = name.split("_")[0]
    n_params = len(tm.all_parameters())
    want_ops = {"value": {"clip": n_params},
                "norm": {"clip_by_norm": n_params},
                "global": {"squared_l2_norm": n_params,
                           "elementwise_max": 1}}[kind]
    assert {t: ops.count(t) for t in want_ops} == want_ops
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
        want = [float(jexe.run(jm, feed=mlp_feed(i), fetch_list=[jl])[0])
                for i in range(3)]
    tscope = tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(),
                                        tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = [float(texe.run(tm, feed=mlp_feed(i), fetch_list=[tl],
                          scope=tscope)[0]) for i in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for n in arrays:
        a = np.asarray(jscope.find_var(n), np.float64)
        err = np.linalg.norm(tscope.as_numpy(n) - a) / max(
            np.linalg.norm(a), 1e-30)
        assert err <= 1e-5, (n, err)
    # a bound that clips moves the weights less than one that does not
    if name.endswith(("clips", "above")):
        other = name.replace("clips", "passes").replace("above", "below")
        om, os_, ol = build_mlp(tfluid, CLIPS[other])
        oscope = tfluid.io.state_from_numpy(om, arrays, tfluid.Scope(),
                                            tfluid.CPUPlace())
        texe.run(om, feed=mlp_feed(0), fetch_list=[ol], scope=oscope)
        w = tm.all_parameters()[0].name
        tscope1 = tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(),
                                             tfluid.CPUPlace())
        texe.run(tm, feed=mlp_feed(0), fetch_list=[tl], scope=tscope1)
        moved = np.abs(tscope1.as_numpy(w) - arrays[w]).sum()
        free = np.abs(oscope.as_numpy(w) - arrays[w]).sum()
        assert moved < free


def test_global_norm_clip_reads_float32_gradients_under_amp():
    from paddle_tpu_torch.core import registry

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", shape=[16])
        y = tfluid.layers.data("y", shape=[1], dtype="int64")
        h = tfluid.layers.fc(x, 32, act="sigmoid")
        loss = tfluid.layers.mean(tfluid.layers.softmax_with_cross_entropy(
            tfluid.layers.fc(h, 4), y))
        tfluid.clip.set_gradient_clip(
            tfluid.clip.GradientClipByGlobalNorm(0.05))
        tfluid.amp.decorate(tfluid.optimizer.Lamb(0.01)).minimize(loss)
    seen = []
    inner = registry._OP_REGISTRY["squared_l2_norm"]

    def spy(ctx):
        seen.append(ctx.input("X").dtype)
        inner(ctx)

    registry._OP_REGISTRY["squared_l2_norm"] = spy
    try:
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        lv, = exe.run(main, feed=mlp_feed(), fetch_list=[loss], scope=scope)
    finally:
        registry._OP_REGISTRY["squared_l2_norm"] = inner
    assert np.isfinite(lv).all()
    assert seen == [torch.float32] * 4
