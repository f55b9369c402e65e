"""The port's optimizer family matches the JAX package's.

Each update op (``adagrad``, ``adamw``, ``adamax``, ``decayed_adagrad``,
``adadelta``, ``rmsprop``, ``ftrl``, ``proximal_gd``,
``proximal_adagrad``, ``lamb``) runs through each package's registered
implementation on the same ``RandomState`` inputs (float32), over its
attrs: every output within 1e-6 of the JAX package's, relative to the
output's largest magnitude. The SelectedRows branches of ``momentum``,
``adagrad``, ``proximal_gd`` and ``proximal_adagrad`` take a gradient of
12 rows with repeated ids into a [20, 3] table and are held the same way
(the port updates the table in place; rows no id names must stay as they
were, bit for bit). ``average_accumulates`` runs 8 updates that cross a
spill (at 16384 updates) and window rollovers (windows of 2 and 3),
its counters compared by value (int64 in the port, int32 in the JAX
package's 32-bit mode).

Each optimizer class trains a 2-layer MLP for 3 steps in both packages
from the JAX startup state (``io.state_from_numpy``): the op lists equal,
losses within 1e-5 relative and every persistable within 1e-5 norm-wise.
``ModelAverage``'s ``apply`` swaps in the JAX package's averages (1e-6)
and ``restore`` brings back the parameters bit for bit. Every op type the
optimizers, the clips and the schedules build is registered in the port.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.sparse import SparseGrad as JSparseGrad
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.sparse import SparseGrad as TSparseGrad

SHAPE = (6, 5)
V, D, N = 20, 3, 12

# op -> (input slots with their kind, output slots)
OPS = {
    "adagrad": ({"Param": "real", "Grad": "real", "Moment": "positive"},
                ["ParamOut", "MomentOut"]),
    "adamw": ({"Param": "real", "Grad": "real", "Moment1": "real",
               "Moment2": "positive", "Beta1Pow": "pow1",
               "Beta2Pow": "pow2"},
              ["ParamOut", "Moment1Out", "Moment2Out"]),
    "adamax": ({"Param": "real", "Grad": "real", "Moment": "real",
                "InfNorm": "positive", "Beta1Pow": "pow1"},
               ["ParamOut", "MomentOut", "InfNormOut", "Beta1PowOut"]),
    "decayed_adagrad": ({"Param": "real", "Grad": "real",
                         "Moment": "positive"}, ["ParamOut", "MomentOut"]),
    "adadelta": ({"Param": "real", "Grad": "real",
                  "AvgSquaredGrad": "positive",
                  "AvgSquaredUpdate": "positive"},
                 ["ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"]),
    "rmsprop": ({"Param": "real", "Grad": "real", "MeanSquare": "positive",
                 "Moment": "real"},
                ["ParamOut", "MeanSquareOut", "MomentOut"]),
    "rmsprop_centered": ({"Param": "real", "Grad": "real",
                          "MeanSquare": "large", "Moment": "real",
                          "MeanGrad": "small"},
                         ["ParamOut", "MeanSquareOut", "MomentOut",
                          "MeanGradOut"]),
    "ftrl": ({"Param": "real", "Grad": "real",
              "SquaredAccumulator": "positive",
              "LinearAccumulator": "real"},
             ["ParamOut", "SquaredAccumOut", "LinearAccumOut"]),
    "proximal_gd": ({"Param": "real", "Grad": "real"}, ["ParamOut"]),
    "proximal_adagrad": ({"Param": "real", "Grad": "real",
                          "Moment": "positive"}, ["ParamOut", "MomentOut"]),
    "lamb": ({"Param": "real", "Grad": "real", "Moment1": "real",
              "Moment2": "positive", "Beta1Pow": "pow1", "Beta2Pow": "pow2"},
             ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
              "Beta2PowOut"]),
}

CASES = [
    ("adagrad", {"epsilon": 1e-6}),
    ("adagrad", {"epsilon": 1e-3}),
    ("adamw", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
               "weight_decay": 0.01}),
    ("adamw", {"beta1": 0.8, "beta2": 0.99, "epsilon": 1e-8,
               "weight_decay": 0.1}),
    ("adamax", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("adamax", {"beta1": 0.5, "beta2": 0.9, "epsilon": 1e-4}),
    ("decayed_adagrad", {"decay": 0.95, "epsilon": 1e-6}),
    ("decayed_adagrad", {"decay": 0.5, "epsilon": 1e-2}),
    ("adadelta", {"rho": 0.95, "epsilon": 1e-6}),
    ("adadelta", {"rho": 0.5, "epsilon": 1e-2}),
    ("rmsprop", {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.0,
                 "centered": False}),
    ("rmsprop", {"decay": 0.9, "epsilon": 1e-10, "momentum": 0.9,
                 "centered": False}),
    ("rmsprop_centered", {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5,
                          "centered": True}),
    ("ftrl", {"l1": 0.0, "l2": 0.0, "lr_power": -0.5}),
    ("ftrl", {"l1": 0.05, "l2": 0.01, "lr_power": -0.5}),
    ("ftrl", {"l1": 0.05, "l2": 0.01, "lr_power": -0.3}),
    ("proximal_gd", {"l1": 0.0, "l2": 0.0}),
    ("proximal_gd", {"l1": 0.1, "l2": 0.01}),
    ("proximal_adagrad", {"l1": 0.0, "l2": 0.01}),
    ("proximal_adagrad", {"l1": 0.1, "l2": 0.01}),
    ("lamb", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
              "weight_decay": 0.01}),
    ("lamb", {"beta1": 0.9, "beta2": 0.99, "epsilon": 1e-6,
              "weight_decay": 0.0}),
]


def draw(kind, shape, rng):
    x = rng.randn(*shape).astype(np.float32)
    if kind == "positive":
        return np.abs(x) + 0.1
    if kind == "large":
        return np.abs(x) + 2.0
    if kind == "small":
        return x * 0.1
    if kind in ("pow1", "pow2"):
        return np.array([0.9 ** 3 if kind == "pow1" else 0.999 ** 3],
                        np.float32)
    return x


def fake_op(op_type, inputs, outputs, attrs):
    return types.SimpleNamespace(
        type=op_type, attrs=dict(attrs), block=None,
        inputs={k: [k] for k in inputs}, outputs={k: [k] for k in outputs})


def run_op(op_type, attrs, inputs, outputs):
    """({slot: array} of the JAX package's op, of the port's op)."""
    jenv = {k: (v if isinstance(v, JSparseGrad) else jnp.asarray(v))
            for k, v in inputs["jax"].items()}
    tenv = {k: (v if isinstance(v, TSparseGrad) else torch.tensor(v))
            for k, v in inputs["port"].items()}
    trace = types.SimpleNamespace(is_test=False, device=torch.device("cpu"))
    names = list(inputs["jax"])
    jreg.get_op_impl(op_type)(jreg.OpContext(
        fake_op(op_type, names, outputs, attrs), jenv, trace))
    treg.get_op_impl(op_type)(treg.OpContext(
        fake_op(op_type, names, outputs, attrs), tenv, trace))
    return ({k: np.asarray(jenv[k]) for k in outputs},
            {k: tenv[k].numpy() for k in outputs})


def scaled_err(got, want):
    return float(np.abs(got.astype(np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name,attrs", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_op_matches_jax(name, attrs):
    slots, outputs = OPS[name]
    rng = np.random.RandomState(0)
    arrays = {s: draw(kind, SHAPE, rng) for s, kind in slots.items()}
    arrays["LearningRate"] = np.array([0.05], np.float32)
    op_type = name.replace("_centered", "")
    want, got = run_op(op_type, attrs, {"jax": arrays, "port": arrays},
                       outputs)
    for k in outputs:
        assert got[k].shape == want[k].shape, k
        assert scaled_err(got[k], want[k]) <= 1e-6, (k, got[k], want[k])


def test_ftrl_zeroes_the_weights_inside_l1():
    """``|lin| <= l1`` sets the weight to 0 on the device: a large l1
    zeroes every weight, as in the JAX package."""
    slots, outputs = OPS["ftrl"]
    rng = np.random.RandomState(0)
    arrays = {s: draw(kind, SHAPE, rng) for s, kind in slots.items()}
    arrays["LearningRate"] = np.array([0.05], np.float32)
    attrs = {"l1": 1e6, "l2": 0.0, "lr_power": -0.5}
    want, got = run_op("ftrl", attrs, {"jax": arrays, "port": arrays},
                       outputs)
    assert not got["ParamOut"].any() and not want["ParamOut"].any()


SPARSE = [
    ("momentum", {"Velocity": "real"}, ["ParamOut", "VelocityOut"],
     {"mu": 0.9, "use_nesterov": False}),
    ("momentum", {"Velocity": "real"}, ["ParamOut", "VelocityOut"],
     {"mu": 0.9, "use_nesterov": True}),
    ("adagrad", {"Moment": "positive"}, ["ParamOut", "MomentOut"],
     {"epsilon": 1e-6}),
    ("proximal_gd", {}, ["ParamOut"], {"l1": 0.0, "l2": 0.01}),
    ("proximal_gd", {}, ["ParamOut"], {"l1": 0.1, "l2": 0.01}),
    ("proximal_adagrad", {"Moment": "positive"}, ["ParamOut", "MomentOut"],
     {"l1": 0.0, "l2": 0.0}),
    ("proximal_adagrad", {"Moment": "positive"}, ["ParamOut", "MomentOut"],
     {"l1": 0.1, "l2": 0.01}),
]


def sparse_ids():
    """12 ids into 20 rows, 19 (the last row) and 3 repeated, 7 distinct."""
    return np.array([3, 19, 5, 3, 0, 19, 11, 3, 7, 5, 19, 12], np.int64)


@pytest.mark.parametrize("op_type,accs,outputs,attrs", SPARSE,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(SPARSE)])
def test_sparse_branch_matches_jax(op_type, accs, outputs, attrs):
    rng = np.random.RandomState(0)
    tables = {"Param": draw("real", (V, D), rng)}
    tables.update({s: draw(k, (V, D), rng) for s, k in accs.items()})
    ids = sparse_ids()
    rows = draw("real", (N, D), rng)
    lr = np.array([0.05], np.float32)
    inputs = {
        "jax": dict(tables, LearningRate=lr,
                    Grad=JSparseGrad(jnp.asarray(ids.astype(np.int32)),
                                     jnp.asarray(rows))),
        "port": dict(tables, LearningRate=lr,
                     Grad=TSparseGrad(torch.tensor(ids), torch.tensor(rows))),
    }
    want, got = run_op(op_type, attrs, inputs, outputs)
    untouched = np.setdiff1d(np.arange(V), ids)
    for k in outputs:
        assert scaled_err(got[k], want[k]) <= 1e-6, (k, got[k], want[k])
        src = tables[k[:-3] if k != "ParamOut" else "Param"]
        np.testing.assert_array_equal(got[k][untouched], src[untouched])
        assert not np.array_equal(got[k][ids], src[ids]), k


def test_adamw_sparse_gradient_matches_jax():
    """AdamW on an ``is_sparse`` table: the rows-only Adam, then the
    decoupled decay of the whole table, as the JAX package computes it."""
    rng = np.random.RandomState(0)
    tables = {"Param": draw("real", (V, D), rng),
              "Moment1": draw("real", (V, D), rng),
              "Moment2": draw("positive", (V, D), rng)}
    ids, rows = sparse_ids(), draw("real", (N, D), rng)
    extra = {"LearningRate": np.array([0.05], np.float32),
             "Beta1Pow": draw("pow1", (1,), rng),
             "Beta2Pow": draw("pow2", (1,), rng)}
    inputs = {
        "jax": dict(tables, **extra, Grad=JSparseGrad(
            jnp.asarray(ids.astype(np.int32)), jnp.asarray(rows))),
        "port": dict(tables, **extra, Grad=TSparseGrad(
            torch.tensor(ids), torch.tensor(rows))),
    }
    outputs = ["ParamOut", "Moment1Out", "Moment2Out"]
    want, got = run_op("adamw", {"weight_decay": 0.1}, inputs, outputs)
    for k in outputs:
        assert scaled_err(got[k], want[k]) <= 1e-6, k


@pytest.mark.parametrize("op_type", ["adamax", "lamb", "ftrl", "rmsprop",
                                     "adadelta", "decayed_adagrad",
                                     "lars_momentum"])
def test_dense_only_ops_refuse_a_sparse_gradient(op_type):
    grad = TSparseGrad(torch.tensor(sparse_ids()), torch.zeros(N, D))
    op = fake_op(op_type, ["Grad"], ["ParamOut"], {})
    env = {"Grad": grad, "Param": torch.zeros(V, D)}
    op.inputs["Param"] = ["Param"]
    with pytest.raises(NotImplementedError, match=op_type):
        treg.get_op_impl(op_type)(treg.OpContext(op, env, None))


ACC_IN = ["Param", "InSum1", "InSum2", "InSum3", "InNumAccumulates",
          "InOldNumAccumulates", "InNumUpdates"]
ACC_OUT = ["OutSum1", "OutSum2", "OutSum3", "OutNumAccumulates",
           "OutOldNumAccumulates", "OutNumUpdates"]


@pytest.mark.parametrize("window", [(0.5, 2, 3), (0.15, 3, 3)])
def test_average_accumulates_spills_and_rolls_over_as_jax(window):
    """From 16380 updates, 8 more: the spill at 16384 and rollovers of
    windows of ``min_average_window``..``max_average_window``."""
    rate, lo, hi = window
    attrs = {"average_window": rate, "min_average_window": lo,
             "max_average_window": hi}
    rng = np.random.RandomState(0)
    sums = [draw("real", SHAPE, rng) for _ in range(3)]
    state = {"jax": {"InSum1": sums[0], "InSum2": sums[1], "InSum3": sums[2],
                     "InNumAccumulates": np.array([1], np.int32),
                     "InOldNumAccumulates": np.array([2], np.int32),
                     "InNumUpdates": np.array([16380], np.int32)}}
    state["port"] = {k: v.astype(np.int64) if v.dtype == np.int32 else v
                     for k, v in state["jax"].items()}
    rolls = spills = 0
    for _ in range(8):
        param = draw("real", SHAPE, rng)
        want, got = run_op("average_accumulates", attrs,
                           {k: dict(v, Param=param) for k, v in
                            state.items()}, ACC_OUT)
        for k in ACC_OUT:
            if k.startswith("OutSum"):
                assert scaled_err(got[k], want[k]) <= 1e-6, k
            else:
                assert got[k].dtype == np.int64 and want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
        rolls += int(got["OutNumAccumulates"][0] == 0)
        spills += int(got["OutNumUpdates"][0] % 16384 == 0)
        for side, out in (("jax", want), ("port", got)):
            state[side] = {"In" + k[3:]: v for k, v in out.items()}
    assert spills == 1 and rolls >= 2


# -- each optimizer class end to end ------------------------------------------

OPTIMIZERS = {
    "SGD": lambda f: f.optimizer.SGD(0.1),
    "Momentum": lambda f: f.optimizer.Momentum(0.1, 0.9),
    "Momentum_nesterov": lambda f: f.optimizer.Momentum(
        0.1, 0.9, use_nesterov=True),
    "LarsMomentum": lambda f: f.optimizer.LarsMomentum(0.1, 0.9),
    "Adagrad": lambda f: f.optimizer.Adagrad(0.1),
    "Adam": lambda f: f.optimizer.Adam(0.01),
    "AdamW": lambda f: f.optimizer.AdamW(0.01, weight_decay=0.01),
    "Adamax": lambda f: f.optimizer.Adamax(0.01),
    "DecayedAdagrad": lambda f: f.optimizer.DecayedAdagrad(0.1),
    "Adadelta": lambda f: f.optimizer.Adadelta(1.0),
    "RMSProp": lambda f: f.optimizer.RMSProp(0.01),
    "RMSProp_centered": lambda f: f.optimizer.RMSProp(
        0.01, momentum=0.9, centered=True),
    "Ftrl": lambda f: f.optimizer.Ftrl(0.1, l1=0.01, l2=0.01),
    "Ftrl_lr_power": lambda f: f.optimizer.Ftrl(0.1, l1=0.01, lr_power=-0.3),
    "ProximalGD": lambda f: f.optimizer.ProximalGD(
        0.1, l1_regularization_strength=0.01,
        l2_regularization_strength=0.01),
    "ProximalAdagrad": lambda f: f.optimizer.ProximalAdagrad(
        0.1, l1_regularization_strength=0.01,
        l2_regularization_strength=0.01),
    "Lamb": lambda f: f.optimizer.Lamb(0.01, lamb_weight_decay=0.01),
}


def build_mlp(fluid, make_opt, average=None):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[16])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 32, act="sigmoid")
        logits = fluid.layers.fc(h, 4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        make_opt(fluid).minimize(loss)
        ma = None if average is None else fluid.optimizer.ModelAverage(
            *average)
    return main, startup, loss, ma


def mlp_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(8, 16).astype("float32"),
            "y": rng.randint(0, 4, (8, 1)).astype("int64")}


def train_both(make_opt, steps=3, average=None):
    """The MLP ``steps`` steps in each package from the JAX startup state:
    (JAX losses, port losses, JAX scope, port scope, startup arrays,
    programs, ModelAverages)."""
    jm, js, jl, jma = build_mlp(jfluid, make_opt, average)
    tm, _, tl, tma = build_mlp(tfluid, make_opt, average)
    assert [op.type for op in tm.global_block.ops] == \
        [op.type for op in jm.global_block.ops]
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
        want = [float(jexe.run(jm, feed=mlp_feed(i), fetch_list=[jl])[0])
                for i in range(steps)]
    tscope = tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(),
                                        tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = [float(texe.run(tm, feed=mlp_feed(i), fetch_list=[tl],
                          scope=tscope)[0]) for i in range(steps)]
    return want, got, jscope, tscope, arrays, (jm, tm), (jma, tma)


def state_err(jscope, tscope, names):
    errs = {}
    for n in names:
        a = np.asarray(jscope.find_var(n), np.float64)
        b = tscope.as_numpy(n).astype(np.float64)
        errs[n] = float(np.linalg.norm(b - a) / max(np.linalg.norm(a),
                                                     1e-30))
    return errs


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_class_matches_jax(name):
    want, got, jscope, tscope, arrays, _, _ = train_both(OPTIMIZERS[name])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    errs = state_err(jscope, tscope, arrays)
    assert max(errs.values()) <= 1e-5, errs
    # the parameters moved
    moved = [n for n in arrays if n.endswith(".w_0")
             and not np.array_equal(tscope.as_numpy(n), arrays[n])]
    assert len(moved) == 2


def test_model_average_apply_and_restore_match_jax():
    """Momentum + ModelAverage(0.15, windows 2..3) for 6 steps: the
    accumulators by value, ``apply`` = the JAX package's averages (1e-6),
    ``restore`` = the trained parameters, bit for bit."""
    want, got, jscope, tscope, arrays, (jm, tm), (jma, tma) = train_both(
        OPTIMIZERS["Momentum"], steps=6, average=(0.15, 2, 3))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    errs = state_err(jscope, tscope, arrays)
    assert max(errs.values()) <= 1e-5, errs
    assert [op.type for op in tm.global_block.ops].count(
        "average_accumulates") == 4
    params = [p.name for p in tm.all_parameters()]
    trained = {n: tscope.find_var(n) for n in params}
    with jfluid.scope_guard(jscope), jma.apply():
        javg = {n: np.asarray(jscope.find_var(n)) for n in params}
    with tfluid.scope_guard(tscope):
        with tma.apply():
            tavg = {n: tscope.find_var(n) for n in params}
            assert all(isinstance(t, torch.Tensor) for t in tavg.values())
        restored = {n: tscope.find_var(n) for n in params}
    for n in params:
        assert tavg[n].dtype == torch.float32
        assert scaled_err(tavg[n].numpy(), javg[n]) <= 1e-6, n
        assert not torch.equal(tavg[n], trained[n])
        assert torch.equal(restored[n], trained[n])


def test_model_average_apply_without_restore_keeps_the_average():
    _, _, _, tscope, _, (_, tm), (_, tma) = train_both(
        OPTIMIZERS["SGD"], steps=3, average=(0.5, 4, 8))
    name = tm.all_parameters()[0].name
    with tfluid.scope_guard(tscope):
        with tma.apply(need_restore=False):
            avg = tscope.find_var(name).clone()
        assert torch.equal(tscope.find_var(name), avg)
        tma.restore()
        assert not torch.equal(tscope.find_var(name), avg)


# -- every op the front ends build is registered -------------------------------

def front_end_op_types():
    """The op types of programs built with every optimizer class,
    ModelAverage, the three clips and the eight schedules."""
    from paddle_tpu_torch import clip

    types_ = set()
    schedules = [
        lambda L: L.noam_decay(64, 4),
        lambda L: L.exponential_decay(0.1, 3, 0.5, staircase=True),
        lambda L: L.natural_exp_decay(0.1, 3, 0.5, staircase=True),
        lambda L: L.inverse_time_decay(0.1, 3, 0.5, staircase=True),
        lambda L: L.polynomial_decay(0.1, 5, 0.0),
        lambda L: L.piecewise_decay([2, 4], [0.1, 0.05, 0.01]),
        lambda L: L.cosine_decay(0.1, 2, 6),
        lambda L: L.linear_lr_warmup(0.1, 3, 0.0, 0.1),
    ]
    clips = [clip.GradientClipByValue(0.1), clip.GradientClipByNorm(0.1),
             clip.GradientClipByGlobalNorm(0.1)]
    for i, make_opt in enumerate(list(OPTIMIZERS.values())):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
            x = tfluid.layers.data("x", shape=[4])
            loss = tfluid.layers.mean(tfluid.layers.fc(x, 2))
            lr_var = schedules[i % len(schedules)](tfluid.layers)
            tfluid.clip.set_gradient_clip(clips[i % len(clips)])
            opt = make_opt(tfluid)
            opt._learning_rate = lr_var
            opt.minimize(loss)
            tfluid.optimizer.ModelAverage(0.15)
            tfluid.layers.append_LARS(
                [(p, p) for p in main.all_parameters()], lr_var, 0.1)
        types_ |= {op.type for op in main.global_block.ops}
    return types_


def test_front_ends_build_only_registered_ops():
    from paddle_tpu_torch.core.registry import registered_ops

    built = front_end_op_types()
    assert {"increment", "clip", "clip_by_norm", "squared_l2_norm",
            "elementwise_max", "less_than", "greater_than", "where",
            "average_accumulates", "lamb", "ftrl"} <= built
    assert built - {"backward_marker"} <= set(registered_ops()), \
        sorted(built - set(registered_ops()))


def layer_op_types():
    """The op types ``layers/nn.py`` names: the first argument of
    ``append_op``, ``_act``, ``_reduce_layer`` and ``_elementwise_layer``,
    the second of ``_single_op_layer``, and ``_GENERATED_UNARY``."""
    import ast
    import pathlib

    import paddle_tpu_torch.layers.nn as nn_mod

    tree = ast.parse(pathlib.Path(nn_mod.__file__).read_text())
    found = set()
    first = ("append_op", "_act", "_reduce_layer", "_elementwise_layer")
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) \
                else getattr(fn, "id", None)
            pos = 0 if name in first else 1 \
                if name == "_single_op_layer" else None
            if pos is not None and len(node.args) > pos \
                    and isinstance(node.args[pos], ast.Constant):
                found.add(node.args[pos].value)
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") == "_GENERATED_UNARY"
                for t in node.targets):
            found |= {e.value for e in node.value.elts}
    return found


# the op types of layers/nn.py the port does not register: none since the
# op remainder (CTC, the sampled heads, the metric, vision-tail, extra and
# host ops) was ported
LAYER_OPS_LEFT = set()


def test_layer_op_types_left_unregistered():
    from paddle_tpu_torch.core.registry import registered_ops

    named = layer_op_types()
    assert len(LAYER_OPS_LEFT) == 0
    assert named - set(registered_ops()) == LAYER_OPS_LEFT
    assert {"warpctc", "ctc_align", "edit_distance", "chunk_eval", "nce",
            "hierarchical_sigmoid", "print", "py_func", "tree_conv",
            "hash"} <= named
    assert {"clip", "clip_by_norm", "increment", "where", "elementwise_max",
            "elementwise_min", "elementwise_pow"} <= named


def appended_op_types():
    """The op types every front end of the port appends: in
    ``layers/*.py``, ``nets.py``, ``backward.py``, ``optimizer.py``,
    ``clip.py`` and ``regularizer.py``, the string given as the op type
    to ``append_op`` (and its relatives, positionally or as ``type=``),
    ``_act``, ``_reduce_layer``, ``_elementwise_layer`` and
    ``_single_op_layer``, an optimizer class's ``type``, and every other
    string literal that names an op of the JAX package (an op type held
    in a table, as the generated layers and the comparison layers
    keep them). Markers the executor skips are left out."""
    import ast
    import pathlib

    import paddle_tpu_torch
    from paddle_tpu.core.registry import registered_ops as jax_ops
    from paddle_tpu_torch.core.interpreter import SKIP_OPS

    root = pathlib.Path(paddle_tpu_torch.__file__).parent
    files = sorted(root.glob("layers/*.py")) + [
        root / n for n in ("nets.py", "backward.py", "optimizer.py",
                           "clip.py", "regularizer.py")]
    type_pos = {"append_op": 0, "_append_op": 0, "prepend_op": 0,
                "_insert_op": 0, "_act": 0, "_reduce_layer": 0,
                "_elementwise_layer": 0, "_single_op_layer": 1}
    names = set(jax_ops())
    found = set()
    for f in files:
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) \
                    else getattr(fn, "id", None)
                pos = type_pos.get(name)
                if pos is not None and len(node.args) > pos \
                        and isinstance(node.args[pos], ast.Constant):
                    found.add(node.args[pos].value)
                if pos is not None:
                    found |= {k.value.value for k in node.keywords
                              if k.arg == "type"
                              and isinstance(k.value, ast.Constant)}
            elif isinstance(node, ast.ClassDef) and any(
                    getattr(b, "name", "") == "_append_optimize_op"
                    for b in node.body):
                found |= {b.value.value for b in node.body
                          if isinstance(b, ast.Assign)
                          and isinstance(b.value, ast.Constant)
                          and any(getattr(t, "id", "") == "type"
                                  for t in b.targets)}
            elif isinstance(node, ast.Constant) and node.value in names:
                found.add(node.value)
    return found - SKIP_OPS


# the op types some front end of the port appends that it does not
# register: none, so every front end's ops run
FRONT_END_OPS_LEFT = LAYER_OPS_LEFT | set()


def test_front_end_op_types_left_unregistered():
    from paddle_tpu_torch.core.registry import registered_ops

    named = appended_op_types()
    assert len(FRONT_END_OPS_LEFT) == 0
    assert named - set(registered_ops()) == FRONT_END_OPS_LEFT
    # what the dense slice made run: layers/tensor.py, layers.load, crop,
    # WeightNormParamAttr's assign, fluid.gradients, the optimizers
    assert {"assign", "fill_constant_batch_size_like", "reverse", "cumsum",
            "range", "linspace", "isfinite", "has_inf", "has_nan", "load",
            "crop", "calc_gradient", "one_hot", "label_smooth", "adam",
            "lamb", "squared_l2_norm", "increment"} <= named
