"""``fluid.gradients`` (the ``calc_gradient`` op) runs in the port as in
the JAX package.

Each program is built by both packages, the JAX startup state carried
into the port (``io.state_from_numpy``), and run on the same feeds
through each ``Executor``: the fetched gradients agree to 1e-5 relative
(1e-6 absolute). Covered: a feed, a cut intermediate, a parameter, a
seeded target gradient, ``no_grad_set``, two markers on one program,
the double grad, a marker after ``minimize`` (and one before it), a
repeated input, an unreached input (zeros), and training through a
gradient: a WGAN-GP style penalty ``||dD/dx||^2`` on a 3-layer MLP under
Adam for 3 steps (losses 1e-5). ``WeightNormParamAttr`` on an ``fc``
(its startup ``assign``) trains 3 steps under a ``reduce_mean`` loss in
both. A dropout before the target draws the forward's mask again in the
replay.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid


def run_both(build, feed, steps=1):
    """Builds ``build(fluid)`` -> fetch vars in each package, runs the JAX
    startup, carries its state into the port, then runs ``steps`` steps
    of main in each. Returns (port rows, JAX rows)."""
    progs = {}
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 5
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            fetch = build(fluid)
        progs[fluid] = (main, startup, fetch)
    jmain, jstart, jfetch = progs[jfluid]
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
        want = [[np.asarray(v) for v in jexe.run(jmain, feed=feed,
                                                 fetch_list=jfetch)]
                for _ in range(steps)]
    tmain, _, tfetch = progs[tfluid]
    tscope = tfluid.io.state_from_numpy(tmain, arrays, tfluid.Scope(),
                                        tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = [[np.asarray(v) for v in texe.run(tmain, feed=feed,
                                            fetch_list=tfetch, scope=tscope)]
           for _ in range(steps)]
    return got, want


def assert_rows(got, want, rtol=1e-5, atol=1e-6):
    for gr, wr in zip(got, want):
        for g, w in zip(gr, wr):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def wrt_feed(fluid):
    x = fluid.layers.data("x", shape=[4])
    y = fluid.layers.reduce_sum(fluid.layers.square(x))
    return fluid.gradients(y, x)


def cut_intermediate(fluid):
    x = fluid.layers.data("x", shape=[4])
    h = fluid.layers.scale(x, scale=3.0)
    y = fluid.layers.reduce_sum(fluid.layers.square(h))
    return fluid.gradients(y, h)


def wrt_parameter(fluid):
    x = fluid.layers.data("x", shape=[4])
    out = fluid.layers.fc(x, size=3, act="tanh")
    loss = fluid.layers.reduce_mean(fluid.layers.square(out))
    return fluid.gradients(loss, fluid.default_main_program()
                           .all_parameters())


def target_seed(fluid):
    x = fluid.layers.data("x", shape=[4])
    seed = fluid.layers.data("seed", shape=[4])
    return fluid.gradients(fluid.layers.square(x), x,
                           target_gradients=seed)


def no_grad(fluid):
    x = fluid.layers.data("x", shape=[4])
    a = fluid.layers.scale(x, scale=2.0)
    b = fluid.layers.scale(x, scale=5.0)
    y = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(a, b))
    return fluid.gradients(y, x, no_grad_set={a.name})


def two_markers(fluid):
    x = fluid.layers.data("x", shape=[4])
    (ga,) = fluid.gradients(fluid.layers.reduce_sum(fluid.layers.square(x)),
                            x)
    (gb,) = fluid.gradients(fluid.layers.reduce_sum(
        fluid.layers.scale(x, scale=7.0)), x)
    return [ga, gb]


def double_grad(fluid):
    x = fluid.layers.data("x", shape=[4])
    y = fluid.layers.reduce_sum(fluid.layers.pow(x, factor=3.0))
    (g1,) = fluid.gradients(y, x)
    z = fluid.layers.reduce_sum(fluid.layers.square(g1))
    (g2,) = fluid.gradients(z, x)
    return [g1, g2]


def after_minimize(fluid):
    x = fluid.layers.data("x", shape=[4])
    out = fluid.layers.fc(x, size=1, bias_attr=False)
    loss = fluid.layers.mean(fluid.layers.square(out))
    fluid.optimizer.SGD(learning_rate=0.0).minimize(loss)
    return fluid.gradients(loss, x) + [loss]


def before_minimize(fluid):
    x = fluid.layers.data("x", shape=[4])
    out = fluid.layers.fc(x, size=1, bias_attr=False)
    w = fluid.default_main_program().all_parameters()[0]
    (gw,) = fluid.gradients(fluid.layers.reduce_sum(out), w)
    loss = fluid.layers.mean(fluid.layers.square(out))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [gw, loss]


def repeated_input(fluid):
    x = fluid.layers.data("x", shape=[4])
    y = fluid.layers.reduce_sum(fluid.layers.square(x))
    return fluid.gradients(y, [x, x])[:1]


def unreached(fluid):
    x = fluid.layers.data("x", shape=[4])
    seed = fluid.layers.data("seed", shape=[4])
    y = fluid.layers.reduce_sum(fluid.layers.square(x))
    return fluid.gradients(y, [x, seed])


CASES = {"wrt_feed": wrt_feed, "cut_intermediate": cut_intermediate,
         "wrt_parameter": wrt_parameter, "target_seed": target_seed,
         "no_grad": no_grad, "two_markers": two_markers,
         "double_grad": double_grad, "after_minimize": after_minimize,
         "before_minimize": before_minimize,
         "repeated_input": repeated_input, "unreached": unreached}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case):
    feed = {"x": np.abs(rand(3, 4)) + 0.5, "seed": rand(3, 4, seed=1)}
    got, want = run_both(CASES[case], feed, steps=2)
    assert_rows(got, want)


def test_unreached_input_gets_zeros():
    feed = {"x": rand(3, 4), "seed": rand(3, 4, seed=1)}
    got, _ = run_both(unreached, feed)
    np.testing.assert_array_equal(got[0][1], np.zeros((3, 4), np.float32))


WIDTH = 64


def gradient_penalty(fluid):
    """A critic D (3 fc layers) trained on mean(D(x)) + 10·mean(
    ||dD/dx||^2): the double-grad idiom of WGAN-GP, under Adam."""
    x = fluid.layers.data("x", shape=[WIDTH])
    h = x
    for i in range(2):
        h = fluid.layers.fc(h, size=WIDTH, act="tanh", name="d%d" % i)
    d = fluid.layers.fc(h, size=1, name="d_out")
    (gx,) = fluid.gradients(fluid.layers.reduce_sum(d), x)
    penalty = fluid.layers.reduce_mean(fluid.layers.reduce_sum(
        fluid.layers.square(gx), dim=[1]))
    loss = fluid.layers.elementwise_add(
        fluid.layers.reduce_mean(d), fluid.layers.scale(penalty, scale=10.0))
    fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return [loss, penalty, gx]


def test_gradient_penalty_trains_as_jax():
    feed = {"x": rand(8, WIDTH)}
    got, want = run_both(gradient_penalty, feed, steps=3)
    assert_rows(got, want, rtol=1e-5, atol=1e-6)
    losses = [r[0] for r in got]
    assert losses[2] < losses[0]


def weight_norm_fc(fluid):
    x = fluid.layers.data("x", shape=[6])
    out = fluid.layers.fc(x, size=4, act="relu", param_attr=(
        fluid.WeightNormParamAttr(dim=1, name="wn")))
    loss = fluid.layers.reduce_mean(fluid.layers.square(
        fluid.layers.fc(out, size=1)))
    fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return [loss]


def test_weight_norm_param_attr_trains_as_jax():
    got, want = run_both(weight_norm_fc, {"x": rand(5, 6)}, steps=3)
    assert_rows(got, want, rtol=1e-5)


def test_replay_draws_the_forward_dropout_mask():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", shape=[64])
        d = tfluid.layers.dropout(x, dropout_prob=0.5)
        y = tfluid.layers.reduce_sum(tfluid.layers.scale(d, scale=3.0))
        (gx,) = tfluid.gradients(y, x)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    xs = np.abs(rand(4, 64)) + 1.0
    dv, gv = exe.run(main, feed={"x": xs}, fetch_list=[d, gx], scope=scope)
    kept = dv != 0
    assert 0 < kept.mean() < 1
    np.testing.assert_array_equal(gv != 0, kept)
    np.testing.assert_allclose(gv[kept], 3.0)
