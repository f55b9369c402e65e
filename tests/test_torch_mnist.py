"""The port trains the MNIST models as the JAX package does.

``models.mnist.mlp`` (784-200-200-10) and ``lenet5`` (1 x 28 x 28,
conv-pool-conv-pool-fc) built by both packages; the JAX startup weights
carried by ``io.state_from_numpy``; three steps of SGD and of Momentum
(lr 0.1 and 0.05 for the MLP; 1e-3 and 5e-4 for LeNet-5, whose
convolutions see the clusters' unnormalised pixels, of standard deviation
3) on one batch of 64 drawn from the synthetic separable clusters of
``tests/test_mnist_mlp.py`` (no download). Losses and
accuracies fetched at each step, and every persistable after the last,
to 1e-5 (float32, another summation order; no batch norm here, so no sum
that cancels). Then the MLP converges as the reference's own test asks
(6 epochs of Adam over 512 examples: loss below 0.25, accuracy above 0.9).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import mnist as jmn
from paddle_tpu_torch.models import mnist as tmn

TOL = 1e-5


def synthetic_mnist(rng, n=512, dim=784, classes=10):
    """Linearly separable clusters (``tests/test_mnist_mlp.py``)."""
    centers = rng.randn(classes, dim).astype("float32") * 3.0
    ys = rng.randint(0, classes, size=n)
    xs = centers[ys] + rng.randn(n, dim).astype("float32") * 0.5
    return xs.astype("float32"), ys.reshape(n, 1).astype("int64")


def build(fluid, mn, model, opt):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        shape = [784] if model == "mlp" else [1, 28, 28]
        img = fluid.layers.data("img", shape=shape)
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        _, loss, acc = getattr(mn, model)(img, label)
        scale = 1.0 if model == "mlp" else 0.01
        if opt == "sgd":
            fluid.optimizer.SGD(learning_rate=0.1 * scale).minimize(loss)
        elif opt == "momentum":
            fluid.optimizer.Momentum(learning_rate=0.05 * scale,
                                     momentum=0.9).minimize(loss)
        else:
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss, acc


def feed_of(xs, ys, model):
    return {"img": xs if model == "mlp" else xs.reshape(-1, 1, 28, 28),
            "label": ys}


@pytest.mark.parametrize("opt", ["sgd", "momentum"])
@pytest.mark.parametrize("model", ["mlp", "lenet5"])
def test_mnist_model_matches_jax_over_3_steps(model, opt):
    jm, js, jl, ja = build(jfluid, jmn, model, opt)
    tm, _, tl, ta = build(tfluid, tmn, model, opt)
    assert [op.type for op in tm.global_block.ops] == \
        [op.type for op in jm.global_block.ops]
    xs, ys = synthetic_mnist(np.random.RandomState(0), n=64)
    feed = feed_of(xs, ys, model)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
        want = [jexe.run(jm, feed=feed, fetch_list=[jl, ja])
                for _ in range(3)]
    tscope = tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(),
                                        tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = [texe.run(tm, feed=feed, fetch_list=[tl, ta], scope=tscope)
           for _ in range(3)]
    np.testing.assert_allclose([float(g[0]) for g in got],
                               [float(w[0]) for w in want], rtol=TOL)
    np.testing.assert_array_equal([float(g[1]) for g in got],
                                  [float(w[1]) for w in want])
    assert float(got[-1][0]) < float(got[0][0])
    names = [v.name for v in tm.list_vars() if v.persistable]
    if opt == "momentum":
        assert any(n.endswith("_momentum_velocity_0") for n in names)
    for n in names:
        np.testing.assert_allclose(tscope.as_numpy(n),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=TOL, atol=TOL, err_msg=n)


def test_mnist_mlp_converges():
    """The reference's convergence gate, run by the port: 6 epochs of
    Adam(1e-3), batch 64, over 512 cluster examples."""
    main, startup, loss, acc = build(tfluid, tmn, "mlp", "adam")
    xs, ys = synthetic_mnist(np.random.RandomState(42))
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    first = None
    for _ in range(6):
        for i in range(0, len(xs), 64):
            lv, av = exe.run(main, feed={"img": xs[i:i + 64],
                                         "label": ys[i:i + 64]},
                             fetch_list=[loss, acc], scope=scope)
            first = float(lv) if first is None else first
    assert float(lv) < 0.25 and float(lv) < first, (first, float(lv))
    assert float(av) > 0.9
