"""The port trains VGG-16, SE-ResNeXt, the ``fluid.nets`` compositions and
LARS as the JAX package does.

Each program is built by both packages (equal op for op and var for var);
the JAX startup program initialises it, ``io.state_from_numpy`` carries
every persistable into the port, and each package trains 3 steps on one
``RandomState(0)`` batch on the CPU. Dropout is set to 0 in both (the
packages draw different masks).

* ``fluid.nets``: ``simple_img_conv_pool``, ``img_conv_group`` (with and
  without batch norm), ``glu`` and ``scaled_dot_product_attention`` in one
  program, SGD: losses 1e-5 relative, parameters 1e-5 norm-wise.
* LARS (``LarsMomentumOptimizer(0.1, 0.9)``, coefficient 0.001, decay
  0.0005) on a 2-layer MLP: losses 1e-6, state 1e-6 norm-wise; the op's
  branches (a zero parameter, a zero gradient) against the JAX op.
* SE-ResNeXt at ``layers_cfg=(1, 1)``, cardinality 8, base (32, 64),
  3 x 32 x 32, batch 4, under the published recipe's
  ``Momentum(…, regularization=L2Decay(1e-4))`` (lr 0.01): losses 1e-6
  relative, every persistable 1e-5 norm-wise, each parameter's update
  (p3 − p0) and each velocity 1e-4 norm-wise (measured 1.1e-7, 3.2e-6 and
  3.2e-5).
* VGG-16 with batch norm at 3 x 32 x 32, batch 4, ``Momentum(1e-3,
  0.9)``. Its last conv group normalises 16 values a channel and its 2-D
  batch norm (on the first fc) 4 values a feature, so float32 keeps few
  digits after a step: the two packages' losses part by 1e-3 at step 3.
  A third run replays the port's program in float64 (its loss through
  the composed softmax, which K2's float32 plain version does not take),
  and each float32 side is held to it, then to each other: the first
  loss 1e-5 relative (measured: port 3.5e-6, JAX 1.9e-7); every loss
  5e-3 (port 1.3e-3, JAX 1.1e-4, port vs JAX 1.3e-3); each parameter's
  update, velocity and moving statistic 5e-2 norm-wise (port 2.4e-2,
  JAX 1.4e-2, port vs JAX 2.8e-2). Neither side is the one that moves:
  the port is closer to float64 at step 2, JAX at step 3. The biases of
  the 13 convolutions and of the fc that feed a batch norm have a zero
  gradient in exact arithmetic; each side moves them by rounding noise
  only (below 1e-7; measured 7.6e-9), their velocities below 1e-5
  (measured 1.0e-6); so does the nets program's one such bias. Under
  VGG's bench optimizer, ``Adam(1e-3)``, the port's first loss equals the JAX package's forward
  (1e-5) and its losses fall; Adam turns those zero gradients' noise into
  steps of ±lr, so its state is not compared.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.models import se_resnext as jse
from paddle_tpu.models import vgg as jvgg
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.models import se_resnext as tse
from paddle_tpu_torch.models import vgg as tvgg

STEPS = 3


def no_dropout(main):
    for op in main.global_block.ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0


def image_feed(batch=4, shape=(3, 32, 32), classes=10):
    rng = np.random.RandomState(0)
    return {"img": rng.randn(batch, *shape).astype("float32"),
            "label": rng.randint(0, classes, (batch, 1)).astype("int64")}


def assert_same_program(tm, jm):
    assert [op.type for op in tm.global_block.ops] == \
        [op.type for op in jm.global_block.ops]
    assert [(v.name, v.shape) for v in tm.list_vars()] == \
        [(v.name, v.shape) for v in jm.list_vars()]


def train_both(jprog, tprog, feed, steps=STEPS):
    """(start arrays, JAX losses, JAX state, port losses, port state)."""
    (jm, js, jl), (tm, _, tl) = jprog, tprog
    assert_same_program(tm, jm)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        start = {n: np.asarray(v) for n, v in jscope.vars.items()}
        jlosses = [float(jexe.run(jm, feed=feed, fetch_list=[jl])[0])
                   for _ in range(steps)]
    jstate = {n: np.asarray(v, np.float32) for n, v in jscope.vars.items()}
    tlosses, tstate = train_port(tprog, start, feed, steps)
    return start, jlosses, jstate, tlosses, tstate


def train_port(prog, start, feed, steps=STEPS):
    main, _, loss = prog
    scope = tfluid.io.state_from_numpy(main, start, tfluid.Scope(),
                                       tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    return losses, {n: scope.as_numpy(n).astype(np.float64)
                    for n in scope.vars}


def rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)) / np.abs(want)


def norm_err(got, want, base=0.0):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want - base), 1e-30))


def build_nets(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", shape=[1, 12, 12])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        x = fluid.nets.simple_img_conv_pool(
            img, num_filters=4, filter_size=3, pool_size=2, pool_stride=2,
            conv_padding=1, act="relu")
        x = fluid.nets.img_conv_group(
            x, conv_num_filter=[6, 6], pool_size=2, pool_stride=2,
            conv_act="relu", conv_with_batchnorm=[True, False],
            pool_type="avg")
        seq = fluid.layers.reshape(x, [0, 6, 9])
        att = fluid.nets.scaled_dot_product_attention(seq, seq, seq,
                                                      num_heads=3)
        gated = fluid.nets.glu(fluid.layers.fc(att, 8, num_flatten_dims=2),
                               dim=-1)
        logits = fluid.layers.fc(gated, 5)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_nets_compositions_train_as_jax_does():
    feed = image_feed(8, (1, 12, 12), 5)
    start, jl, js, tl, ts = train_both(build_nets(jfluid),
                                       build_nets(tfluid), feed)
    assert {"sigmoid", "split", "batch_norm"} <= {
        op.type for op in build_nets(tfluid)[0].global_block.ops}
    assert tl[-1] < tl[0]
    assert rel(tl, jl).max() <= 1e-5, (tl, jl)
    main = build_nets(tfluid)[0]
    biases = pre_bn_biases(main)
    assert len(biases) == 1
    for n in start:
        if n in biases:
            assert_noise_only(n, start, ts, js)
        else:
            assert norm_err(ts[n], js[n]) <= 1e-5, n


def build_lars_mlp(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[16])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 32, act="relu")
        logits = fluid.layers.fc(h, 4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.LarsMomentumOptimizer(0.1, 0.9).minimize(loss)
    return main, startup, loss


def test_lars_mlp_trains_as_jax_does():
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(8, 16).astype("float32"),
            "y": rng.randint(0, 4, (8, 1)).astype("int64")}
    tprog = build_lars_mlp(tfluid)
    assert [op.type for op in tprog[0].global_block.ops].count(
        "lars_momentum") == 4
    start, jl, js, tl, ts = train_both(build_lars_mlp(jfluid), tprog, feed)
    assert tl[-1] < tl[0]
    assert rel(tl, jl).max() <= 1e-6, (tl, jl)
    for n in start:
        assert norm_err(ts[n], js[n]) <= 1e-6, n


@pytest.mark.parametrize("case", ["both", "zero_param", "zero_grad"])
def test_lars_op_branches_match_jax(case):
    """local_lr = lr·coeff·‖p‖/(‖g‖ + decay·‖p‖) where both norms are
    positive, else lr."""
    rng = np.random.RandomState(3)
    vals = {"Param": rng.randn(5, 7).astype(np.float32),
            "Grad": rng.randn(5, 7).astype(np.float32),
            "Velocity": rng.randn(5, 7).astype(np.float32),
            "LearningRate": np.array([0.1], np.float32)}
    if case == "zero_param":
        vals["Param"][:] = 0
    elif case == "zero_grad":
        vals["Grad"][:] = 0
    attrs = {"mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 0.0005}
    outs = {}
    for reg, tensor, key in ((jreg, jnp.asarray, "jax"),
                             (treg, torch.tensor, "port")):
        op = types.SimpleNamespace(
            type="lars_momentum", attrs=attrs, block=None,
            inputs={k: [k] for k in vals},
            outputs={"ParamOut": ["p"], "VelocityOut": ["v"]})
        env = {k: tensor(v) for k, v in vals.items()}
        reg.get_op_impl("lars_momentum")(reg.OpContext(op, env, None))
        outs[key] = (np.asarray(env["p"]), np.asarray(env["v"]))
    for got, want in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def build_se(fluid, se):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", shape=[3, 32, 32])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        loss, _ = se.se_resnext(img, label, class_num=10, layers_cfg=(1, 1),
                                cardinality=8, base_filters=(32, 64))
        fluid.optimizer.Momentum(
            0.01, 0.9, regularization=fluid.regularizer.L2Decay(1e-4)
        ).minimize(loss)
    no_dropout(main)
    return main, startup, loss


def test_se_resnext_trains_as_jax_does():
    tprog = build_se(tfluid, tse)
    ops = [op.type for op in tprog[0].global_block.ops]
    n_params = len(tprog[0].all_parameters())
    assert ops.count("sum") == n_params and ops.count("sigmoid") == 2
    assert any(op.type == "conv2d" and op.attrs["groups"] == 8
               for op in tprog[0].global_block.ops)
    start, jl, js, tl, ts = train_both(build_se(jfluid, jse), tprog,
                                       image_feed())
    assert tl[-1] < tl[0]
    assert rel(tl, jl).max() <= 1e-6, (tl, jl)
    params = {p.name for p in tprog[0].all_parameters()}
    for n in start:
        assert norm_err(ts[n], js[n]) <= 1e-5, n
        if n in params or "_velocity" in n:
            base = start[n] if n in params else 0.0
            assert norm_err(ts[n], js[n], base) <= 1e-4, n


def build_vgg(fluid, vgg, opt="momentum", dtype="float32"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", shape=[3, 32, 32], dtype=dtype)
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        loss, _ = vgg.vgg16(img, label, class_num=10)
        if opt == "adam":
            fluid.optimizer.Adam(1e-3).minimize(loss)
        else:
            fluid.optimizer.Momentum(1e-3, 0.9).minimize(loss)
    no_dropout(main)
    return main, startup, loss


def vgg_float64(start, feed):
    """The port's VGG program built in float64 (every parameter, moving
    statistic and velocity float64), its loss through the composed
    softmax (a ``Softmax`` output wired), trained from the float32 start."""
    main, startup, loss = build_vgg(tfluid, tvgg, dtype="float64")
    blk = main.global_block
    for op in blk.ops:
        if op.type == "softmax_with_cross_entropy":
            op.outputs["Softmax"] = [blk.create_var(
                name="softmax_f64", dtype="float64").name]
    assert {v.dtype for v in main.list_vars() if v.persistable
            and not v.name.startswith("learning_rate")} == {"float64"}
    return train_port((main, startup, loss), start, feed)


@pytest.fixture(scope="module")
def vgg_runs():
    feed = image_feed()
    tprog = build_vgg(tfluid, tvgg)
    start, jl, js, tl, ts = train_both(build_vgg(jfluid, jvgg), tprog, feed)
    fl, fs = vgg_float64(start, feed)
    return dict(main=tprog[0], start=start, feed=feed, jax=(jl, js),
                port=(tl, ts), f64=(fl, fs))


def pre_bn_biases(main):
    """The biases added just before a batch norm (all 13 conv biases and
    the first fc's): their gradient is 0 in exact arithmetic."""
    ops = main.global_block.ops
    bn_inputs = {op.inputs["X"][0] for op in ops if op.type == "batch_norm"}
    return {op.inputs["Y"][0] for op in ops if op.type == "elementwise_add"
            and op.outputs["Out"][0] in bn_inputs}


def assert_noise_only(n, start, *states):
    """A bias whose gradient is 0 in exact arithmetic (it feeds a batch
    norm): it moves by rounding noise only, and its velocity (the summed
    gradients) stays noise."""
    for state in states:
        if "_velocity" in n:
            assert np.abs(state[n]).max() <= 1e-5, n
        else:
            assert np.abs(state[n] - start[n]).max() <= 1e-7, n


def test_vgg16_trains_as_jax_does(vgg_runs):
    main, start = vgg_runs["main"], vgg_runs["start"]
    (jl, js), (tl, ts), (fl, fs) = (vgg_runs["jax"], vgg_runs["port"],
                                     vgg_runs["f64"])
    assert np.isfinite(tl).all() and tl[-1] < tl[0]
    assert rel(tl[0], fl[0]) <= 1e-5 and rel(jl[0], fl[0]) <= 1e-5
    for got, want in ((tl, fl), (jl, fl), (tl, jl)):
        assert rel(got, want).max() <= 5e-3, (got, want)
    biases = pre_bn_biases(main)
    assert len(biases) == 14
    params = {p.name for p in main.all_parameters()}
    for n in start:
        if n.startswith("learning_rate"):
            continue
        if any(n.startswith(b) for b in biases):
            assert_noise_only(n, start, ts, js)
            continue
        base = start[n] if n in params else 0.0
        for got, want in ((ts[n], fs[n]), (js[n], fs[n]), (ts[n], js[n])):
            assert norm_err(got, want, base) <= 5e-2, n


def test_vgg16_trains_under_adam(vgg_runs):
    """The bench's optimizer: the first loss is the forward both packages
    computed in the Momentum legs (the Adam moments from the port's own
    startup program, the weights from the JAX one)."""
    prog = build_vgg(tfluid, tvgg, "adam")
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(prog[1], scope=scope)
    arrays = {n: scope.as_numpy(n) for n in scope.vars}
    arrays.update(vgg_runs["start"])
    losses, _ = train_port(prog, arrays, vgg_runs["feed"], 4)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert rel(losses[0], vgg_runs["jax"][0][0]) <= 1e-5
