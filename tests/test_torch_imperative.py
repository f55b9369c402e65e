"""The port's dygraph mode (``paddle_tpu_torch.imperative``) against the
JAX package's: a twin of each test of ``tests/test_imperative.py``, run
on ``CPUPlace()`` and held to the JAX package where both compute the same
thing (the same weights carried over as numpy arrays or through
``save_dygraph`` files, which cross between the packages both ways).
Floats agree to 1e-5. ``jit`` and ``jit_train`` run their eager step on
the CPU and say so (``captured`` is False); ``guard()`` without a place
asks for the card and raises without one. The card's captures are in
``tests/test_torch_detection_cuda.py``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import imperative as jimp
from paddle_tpu_torch import imperative
from paddle_tpu_torch.imperative import F, to_variable

CPU = fluid.CPUPlace()


def guard(seed=0):
    return imperative.guard(CPU, seed=seed)


def _synthetic(rng, n=256, dim=32, classes=10):
    centers = rng.randn(classes, dim).astype("float32") * 3.0
    ys = rng.randint(0, classes, size=n)
    xs = centers[ys] + rng.randn(n, dim).astype("float32") * 0.5
    return xs.astype("float32"), ys.reshape(n, 1).astype("int64")


def _mlp_class(imp):
    class MLP(imp.Layer):
        def __init__(self, name_scope, dim=32, classes=10):
            super().__init__(name_scope)
            self._fc1 = imp.FC(self.full_name(), 64, act="relu")
            self._fc2 = imp.FC(self.full_name(), classes)

        def forward(self, x):
            return self._fc2(self._fc1(x))

    return MLP


MLP = _mlp_class(imperative)
JMLP = _mlp_class(jimp)


def _jax_state(tmp_path, build, x, seed=0):
    """Builds a JAX dygraph model, saves it with the JAX package's
    ``save_dygraph``; → (path, JAX forward output)."""
    path = str(tmp_path / "jax_model")
    with jimp.guard(seed=seed):
        m = build()
        out = m(jimp.to_variable(x)).numpy()
        jimp.save_dygraph(m, path)
    return path, out


def test_to_variable_roundtrip_and_guard():
    assert not imperative.enabled()
    with guard():
        assert imperative.enabled()
        x = to_variable(np.arange(6, dtype="float32").reshape(2, 3))
        assert x.shape == (2, 3)
        assert x.dtype == "float32"
        assert x.value.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), np.arange(6).reshape(2, 3))
    assert not imperative.enabled()
    with pytest.raises(RuntimeError):
        to_variable(np.zeros(3))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the GPU-less case")
def test_guard_without_a_place_asks_for_the_card():
    with pytest.raises(RuntimeError, match="cuda"):
        with imperative.guard():
            pass
    assert not imperative.enabled()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the GPU-less case")
def test_outside_guard_layers_ops_and_jit_ask_for_the_card():
    """No guard is no ``CPUPlace()``: a layer's weights and an op's
    inputs go to the card, and ``jit``/``jit_train`` need the guard's
    device; without a card each raises instead of running on the CPU."""
    fc = imperative.FC("fc", 4)
    with pytest.raises(RuntimeError, match="cuda"):
        fc(np.zeros((2, 3), "float32"))
    with pytest.raises(RuntimeError, match="cuda"):
        imperative.Conv2D("conv", 3, 4, 3)
    with pytest.raises(RuntimeError, match="cuda"):
        imperative.dispatch("relu", {"X": np.zeros((2, 3), "float32")})
    with pytest.raises(RuntimeError, match="guard"):
        imperative.jit(fc)(torch.zeros(2, 3))
    step = imperative.jit_train(lambda x: F.mean(fc(x)), fc,
                                fluid.optimizer.SGD(0.1))
    with pytest.raises(RuntimeError, match="guard"):
        step(torch.zeros(2, 3))
    assert not step.captured


def test_eager_autograd_matches_analytic():
    with guard():
        x = to_variable(np.array([[1.0, 2.0], [3.0, 4.0]], dtype="float32"))
        y = x * x + 2.0 * x  # dy/dx = 2x + 2
        loss = F.mean(y)
        loss._backward()
        expect = (2.0 * x.numpy() + 2.0) / x.numpy().size
        np.testing.assert_allclose(x.gradient(), expect, rtol=1e-6)


def test_grad_accumulates_across_uses():
    with guard():
        x = to_variable(np.ones((3,), dtype="float32"))
        loss = F.reduce_sum(x * 3.0 + x * 5.0)
        loss.backward()
        np.testing.assert_allclose(x.gradient(), np.full(3, 8.0), rtol=1e-6)


def test_stop_gradient_blocks_flow():
    with guard():
        x = to_variable(np.ones((3,), dtype="float32"))
        w = to_variable(np.ones((3,), dtype="float32"))
        w.stop_gradient = True
        loss = F.reduce_sum(x * w)
        loss.backward()
        assert x.gradient() is not None
        assert w.gradient() is None


def test_layer_parameter_registry():
    with guard():
        mlp = MLP("mlp")
        mlp(to_variable(np.zeros((4, 32), dtype="float32")))  # builds lazy FCs
        params = mlp.parameters()
        assert len(params) == 4  # 2 FCs × (w, b)
        assert len(mlp.sublayers()) == 2
        assert all(p.persistable for p in params)
        loss = F.mean(mlp(to_variable(np.ones((4, 32), dtype="float32"))))
        loss.backward()
        assert any(p.gradient() is not None for p in params)
        mlp.clear_gradients()
        assert all(p.gradient() is None for p in params)
    with jimp.guard():
        jm = JMLP("mlp")
        jm(jimp.to_variable(np.zeros((4, 32), dtype="float32")))
        assert sorted(p.name for p in jm.parameters()) == sorted(
            p.name for p in params)


def test_pylayer_custom_op():
    """The forward is differentiated; a custom backward is not used, in
    either package."""
    def classes(imp):
        class Square(imp.PyLayer):
            @staticmethod
            def forward(x):
                return x * x

            @staticmethod
            def backward(dout):
                return dout * 10.0

        return Square

    with guard():
        x = to_variable(np.array([2.0, 3.0], dtype="float32"))
        F.reduce_sum(classes(imperative).apply(x)).backward()
        np.testing.assert_allclose(x.gradient(), [4.0, 6.0], rtol=1e-6)
    with jimp.guard():
        jx = jimp.to_variable(np.array([2.0, 3.0], dtype="float32"))
        jimp.F.reduce_sum(classes(jimp).apply(jx)).backward()
        np.testing.assert_allclose(jx.gradient(), x.gradient(), rtol=1e-6)


def _train_mlp(imp, fl, path, xs, ys, epochs=2, batch=64):
    """The dygraph MLP loop of the reference's test, from the weights in
    ``path``; → losses."""
    g = imp.guard(CPU, seed=7) if imp is imperative else imp.guard(seed=7)
    losses = []
    with g:
        mlp = (MLP if imp is imperative else JMLP)("mlp")
        mlp(imp.to_variable(xs[:2]))
        mlp.set_state(imp.load_dygraph(path))
        opt = fl.optimizer.Adam(learning_rate=1e-2)
        for _ in range(epochs):
            for i in range(0, len(xs), batch):
                img = imp.to_variable(xs[i:i + batch])
                label = imp.to_variable(ys[i:i + batch])
                label.stop_gradient = True
                loss = imp.F.mean(imp.F.softmax_with_cross_entropy(mlp(img), label))
                loss._backward()
                opt.minimize(loss)
                mlp.clear_gradients()
                losses.append(float(loss.numpy()))
    return losses


def test_imperative_mnist_mlp_converges_like_the_jax_package(rng, tmp_path):
    xs, ys = _synthetic(rng)
    path, _ = _jax_state(tmp_path, lambda: JMLP("mlp"), xs[:2])
    got = _train_mlp(imperative, fluid, path, xs, ys, epochs=4)
    want = _train_mlp(jimp, jfluid, path, xs, ys, epochs=4)
    assert got[-1] < 0.3 and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_imperative_sgd_matches_static(rng):
    """One SGD step on identical weights/grads must match the port's
    static mode and the JAX package's dygraph."""
    dim, classes = 8, 3
    xs = rng.randn(16, dim).astype("float32")
    ys = rng.randint(0, classes, size=(16, 1)).astype("int64")
    w0 = rng.randn(dim, classes).astype("float32") * 0.1
    b0 = np.zeros(classes, dtype="float32")

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[dim])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = fluid.layers.fc(
            img, size=classes,
            param_attr=fluid.ParamAttr(
                name="w", initializer=fluid.initializer.NumpyArrayInitializer(w0)),
            bias_attr=fluid.ParamAttr(
                name="b", initializer=fluid.initializer.NumpyArrayInitializer(b0)))
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    static_loss, = exe.run(main, feed={"img": xs, "label": ys},
                           fetch_list=[loss], scope=scope)
    static_w = scope.find_var("w").detach().numpy()

    def dygraph(imp, fl, set_value):
        with (imp.guard(CPU) if imp is imperative else imp.guard()):
            fc = imp.FC("fc", classes)
            fc(imp.to_variable(xs))  # build
            set_value(fc.weight, w0)
            set_value(fc.bias, b0)
            label = imp.to_variable(ys)
            label.stop_gradient = True
            dloss = imp.F.mean(imp.F.softmax_with_cross_entropy(
                fc(imp.to_variable(xs)), label))
            dloss._backward()
            fl.optimizer.SGD(learning_rate=0.1).minimize(dloss)
            return float(dloss.numpy()), fc.weight.numpy()

    def set_port(v, a):
        v.value = torch.tensor(a)

    def set_jax(v, a):
        v.value = jnp.asarray(a)

    got_l, got_w = dygraph(imperative, fluid, set_port)
    want_l, want_w = dygraph(jimp, jfluid, set_jax)
    np.testing.assert_allclose(got_l, float(np.asarray(static_loss)), rtol=1e-5)
    np.testing.assert_allclose(got_w, static_w, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    np.testing.assert_allclose(got_w, want_w, rtol=1e-5, atol=1e-6)


def _conv_net(imp):
    conv = imp.Conv2D("conv", num_channels=3, num_filters=8,
                      filter_size=3, padding=1, act="relu")
    pool = imp.Pool2D("pool", pool_size=2, pool_stride=2)
    bn = imp.BatchNorm("bn", num_channels=8)
    emb = imp.Embedding("emb", size=[50, 6])
    return conv, pool, bn, emb


def test_imperative_conv_pool_bn_matches_the_jax_package(rng):
    x = rng.randn(2, 3, 16, 16).astype("float32")
    ids = rng.randint(0, 50, size=(4, 7)).astype("int64")

    def run(imp, guard_):
        with guard_:
            conv, pool, bn, emb = _conv_net(imp)
            return conv, pool, bn, emb

    with jimp.guard():
        jconv, jpool, jbn, jemb = _conv_net(jimp)
        jout = jbn(jpool(jconv(jimp.to_variable(x))))
        je = jemb(jimp.to_variable(ids))
        jloss = jimp.F.mean(jout) + jimp.F.mean(je)
        jloss.backward()
        jstate = {"w": jconv.weight.numpy(), "b": jconv.bias.numpy(),
                  "e": jemb.weight.numpy()}
        want = (jout.numpy(), jbn._mean.numpy(), jconv.weight.gradient(),
                jemb.weight.gradient())
    with guard():
        conv, pool, bn, emb = _conv_net(imperative)
        conv.weight.value = jstate["w"]
        conv.bias.value = jstate["b"]
        emb.weight.value = jstate["e"]
        out = pool(conv(to_variable(x)))
        assert out.shape == (2, 8, 8, 8)
        mean_before = bn._mean.numpy().copy()
        out = bn(out)
        assert not np.allclose(bn._mean.numpy(), mean_before), "BN stats must update"
        e = emb(to_variable(ids))
        assert e.shape == (4, 7, 6)
        loss = F.mean(out) + F.mean(e)
        loss.backward()
        got = (out.numpy(), bn._mean.numpy(), conv.weight.gradient(),
               emb.weight.gradient())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_double_backward_does_not_compound():
    with guard():
        x = to_variable(np.ones((3,), dtype="float32"))
        loss = F.reduce_sum((x * 2.0) * 3.0)
        loss.backward()
        np.testing.assert_allclose(x.gradient(), np.full(3, 6.0))
        loss.backward()
        np.testing.assert_allclose(x.gradient(), np.full(3, 12.0))


def test_adamw_decays_lamb_differs_like_the_jax_package():
    w0 = np.full((4, 4), 2.0, dtype="float32")

    def one_step(imp, make_opt):
        with (imp.guard(CPU) if imp is imperative else imp.guard()):
            fc = imp.FC("fc", 4, bias_attr=False)
            fc(imp.to_variable(np.ones((2, 4), dtype="float32")))
            fc.weight.value = torch.tensor(w0) if imp is imperative else jnp.asarray(w0)
            loss = imp.F.mean(fc(imp.to_variable(np.ones((2, 4), dtype="float32"))))
            loss.backward()
            make_opt().minimize(loss)
            return fc.weight.numpy()

    out = {}
    for imp, fl in ((imperative, fluid), (jimp, jfluid)):
        out[imp] = [one_step(imp, lambda: fl.optimizer.Adam(learning_rate=0.1)),
                    one_step(imp, lambda: fl.optimizer.AdamW(learning_rate=0.1,
                                                             weight_decay=0.5)),
                    one_step(imp, lambda: fl.optimizer.Lamb(learning_rate=0.1))]
    adam, adamw, lamb = out[imperative]
    assert not np.allclose(adam, adamw), "AdamW must differ from Adam (weight decay)"
    assert not np.allclose(adam, lamb), "Lamb must differ from Adam (trust ratio)"
    assert adamw.mean() < adam.mean(), "decay must pull weights toward zero"
    for g, w in zip(out[imperative], out[jimp]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_optimizer_cannot_switch_modes():
    with guard():
        x = to_variable(np.ones((2, 4), dtype="float32"))
        fc = imperative.FC("fc", 2)
        loss = F.mean(fc(x))
        loss.backward()
        opt = fluid.optimizer.SGD(learning_rate=0.1)
        opt.minimize(loss)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[4])
        static_loss = fluid.layers.mean(fluid.layers.fc(img, size=2))
        with pytest.raises(RuntimeError, match="imperative"):
            opt.minimize(static_loss)


def test_bn_stats_are_not_parameters():
    with guard():
        bn = imperative.BatchNorm("bn", num_channels=4)
        names = sorted(p.name for p in bn.parameters())
        assert len(names) == 2, f"BN must expose scale+bias only, got {names}"
        assert not bn._mean.value.requires_grad


def test_bn_eval_mode_uses_running_stats(rng):
    x = rng.randn(8, 4, 6, 6).astype("float32") * 3 + 1
    outs = {}
    for imp in (imperative, jimp):
        with (imp.guard(CPU) if imp is imperative else imp.guard()):
            bn = imp.BatchNorm("bn", num_channels=4)
            bn(imp.to_variable(x))  # one train step seeds running stats
            mean_after_train = bn._mean.numpy().copy()
            bn.eval()
            out = bn(imp.to_variable(x))
            np.testing.assert_array_equal(bn._mean.numpy(), mean_after_train)
            ch_mean = np.abs(out.numpy().mean(axis=(0, 2, 3))).max()
            assert ch_mean > 0.05, "eval-mode BN normalized with batch statistics"
            bn.train()
            bn(imp.to_variable(x))
            assert not np.allclose(bn._mean.numpy(), mean_after_train)
            outs[imp] = (out.numpy(), bn._mean.numpy(), bn._variance.numpy())
    for g, w in zip(outs[imperative], outs[jimp]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_embedding_negative_padding_idx_masks_grad():
    with guard():
        emb = imperative.Embedding("emb", size=[10, 3], padding_idx=-1)
        np.testing.assert_array_equal(emb.weight.numpy()[9], np.zeros(3))
        ids = to_variable(np.array([[9, 1]], dtype="int64"))
        loss = F.mean(emb(ids))
        loss.backward()
        g = emb.weight.gradient()
        np.testing.assert_array_equal(g[9], np.zeros(3, "float32"))
        assert np.abs(g[1]).sum() > 0


def test_imperative_adam_state_persists():
    with guard():
        x = to_variable(np.ones((4, 8), dtype="float32"))
        fc = imperative.FC("fc", 4)
        opt = fluid.optimizer.Adam(learning_rate=1e-2)
        losses = []
        for _ in range(3):
            loss = F.mean(F.square(fc(x)))
            loss.backward()
            opt.minimize(loss)
            fc.clear_gradients()
            losses.append(float(loss.numpy()))
        accs = opt._accumulators["moment1"]
        assert len(accs) == 2  # w and b
        assert losses[-1] < losses[0]


def test_save_load_dygraph_roundtrip_and_across_packages(tmp_path):
    x = np.ones((2, 32), dtype="float32")
    path = str(tmp_path / "model")
    with guard():
        m1 = MLP("mlp")
        m1(to_variable(x))
        out1 = m1(to_variable(x)).numpy()
        imperative.save_dygraph(m1, path)
    with guard():
        m2 = MLP("mlp")
        m2(to_variable(x))  # build (different random init)
        m2.set_state(imperative.load_dygraph(path))
        out2 = m2(to_variable(x)).numpy()
    np.testing.assert_allclose(out1, out2, rtol=1e-6)
    # the port's file loads into the JAX package and the other way round
    with jimp.guard():
        jm = JMLP("mlp")
        jm(jimp.to_variable(x))
        jm.set_state(jimp.load_dygraph(path))
        np.testing.assert_allclose(jm(jimp.to_variable(x)).numpy(), out1,
                                   rtol=1e-5, atol=1e-6)
    jpath, jout = _jax_state(tmp_path, lambda: JMLP("mlp"), x, seed=9)
    assert os.path.exists(jpath + ".npz")
    with guard():
        m3 = MLP("mlp")
        m3(to_variable(x))
        m3.set_state(imperative.load_dygraph(jpath))
        np.testing.assert_allclose(m3(to_variable(x)).numpy(), jout,
                                   rtol=1e-5, atol=1e-6)
    # strict mode flags shape mismatches loudly
    with guard():
        m4 = MLP("mlp", dim=16)
        m4(to_variable(np.ones((2, 16), dtype="float32")))
        with pytest.raises((ValueError, KeyError)):
            m4.set_state(imperative.load_dygraph(path))


class _MLP3(imperative.Layer):
    def __init__(self):
        super().__init__("mlp")
        self.fc1 = imperative.FC("fc1", 64, act="relu")
        self.fc2 = imperative.FC("fc2", 64, act="relu")
        self.fc3 = imperative.FC("fc3", 8)

    def forward(self, x):
        return self.fc3(self.fc2(self.fc1(x)))


def test_imperative_jit_parity_on_the_cpu():
    """On CPUPlace ``jit`` runs the forward eagerly (no capture) and says
    so; parameter updates flow through."""
    with guard(seed=3):
        mlp = _MLP3()
        x = to_variable(np.random.RandomState(0).randn(16, 32).astype("float32"))
        want = mlp(x).numpy()
        fast = imperative.jit(mlp)
        got = fast(x)
        assert fast.captured is False
        assert got.stop_gradient
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        p0 = mlp.parameters()[0]
        p0.value = p0.value + 1.0
        np.testing.assert_allclose(fast(x).numpy(), mlp(x).numpy(),
                                   rtol=1e-6, atol=1e-6)


def _jit_train_losses(imp, fl, path, xs, ys, compiled, n_steps=6, opt="Adam"):
    g = imp.guard(CPU, seed=11) if imp is imperative else imp.guard(seed=11)
    with g:
        mlp = (MLP if imp is imperative else JMLP)("mlp")
        mlp(imp.to_variable(xs[:2]))
        mlp.set_state(imp.load_dygraph(path))
        optim = getattr(fl.optimizer, opt)(learning_rate=1e-2)

        def loss_fn(img, lbl):
            return imp.F.mean(imp.F.softmax_with_cross_entropy(mlp(img), lbl))

        losses = []
        if compiled:
            step = imp.jit_train(loss_fn, mlp, optim)
            for _ in range(n_steps):
                losses.append(float(step(xs, ys).numpy()))
            if imp is imperative:
                assert step.captured is False
        else:
            for _ in range(n_steps):
                img, lbl = imp.to_variable(xs), imp.to_variable(ys)
                lbl.stop_gradient = True
                loss = loss_fn(img, lbl)
                loss._backward()
                optim.minimize(loss)
                mlp.clear_gradients()
                losses.append(float(loss.numpy()))
        return losses, mlp.parameters()[0].numpy()


def test_jit_train_loss_parity_with_eager_and_the_jax_package(rng, tmp_path):
    xs, ys = _synthetic(rng, n=128)
    path, _ = _jax_state(tmp_path, lambda: JMLP("mlp"), xs[:2])
    eager, w_eager = _jit_train_losses(imperative, fluid, path, xs, ys, False)
    jitted, w_jit = _jit_train_losses(imperative, fluid, path, xs, ys, True)
    jax_jit, w_jax = _jit_train_losses(jimp, jfluid, path, xs, ys, True)
    assert jitted[-1] < jitted[0], "jit_train did not reduce the loss"
    np.testing.assert_array_equal(eager, jitted)
    np.testing.assert_array_equal(w_eager, w_jit)
    np.testing.assert_allclose(jitted, jax_jit, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w_jit, w_jax, rtol=1e-5, atol=1e-6)


def test_jit_train_updates_params_on_the_cpu(rng):
    xs, ys = _synthetic(rng, n=64)
    with guard(seed=3):
        mlp = MLP("mlp")
        opt = fluid.optimizer.SGD(learning_rate=0.1)

        def loss_fn(img, lbl):
            return F.mean(F.softmax_with_cross_entropy(mlp(img), lbl))

        step = imperative.jit_train(loss_fn, mlp, opt)
        step(xs, ys)   # eager warmup step
        w = mlp._fc1.parameters()[0]
        tensor = w.value
        w_before = w.numpy().copy()
        step(xs, ys)
        assert step.captured is False
        assert not np.allclose(w_before, w.numpy()), "params not updated"
        assert w.value is tensor, "the update must be in place"


class _ConvBN(imperative.Layer):
    def __init__(self, name_scope, imp=imperative):
        super().__init__(name_scope)
        self._conv = imp.Conv2D(self.full_name(), 4, 8, 3)
        self._bn = imp.BatchNorm(self.full_name(), 8, act="relu")
        self._fc = imp.FC(self.full_name(), 3)

    def forward(self, x):
        return self._fc(self._bn(self._conv(x)))


def test_jit_train_carries_batchnorm_stats(rng):
    xs = rng.randn(16, 4, 6, 6).astype("float32")
    ys = rng.randint(0, 3, (16, 1)).astype("int64")
    with guard(seed=5):
        net = _ConvBN("cbn")
        opt = fluid.optimizer.SGD(learning_rate=0.05)

        def loss_fn(img, lbl):
            return F.mean(F.softmax_with_cross_entropy(net(img), lbl))

        step = imperative.jit_train(loss_fn, net, opt)
        step(xs, ys)                       # eager warmup
        mean1 = net._bn._mean.numpy().copy()
        step(xs, ys)
        mean2 = net._bn._mean.numpy().copy()
        step(xs, ys)
        mean3 = net._bn._mean.numpy().copy()
        assert not np.allclose(mean1, mean2), "BN stats frozen under jit_train"
        assert not np.allclose(mean2, mean3)


def test_jit_train_rejects_same_tape_mixing(rng):
    xs, ys = _synthetic(rng, n=32)
    with guard(seed=13):
        mlp = MLP("mlp")
        opt = fluid.optimizer.SGD(learning_rate=0.1)

        def loss_fn(img, lbl):
            return F.mean(F.softmax_with_cross_entropy(mlp(img), lbl))

        step = imperative.jit_train(loss_fn, mlp, opt)
        step(xs, ys)
        step(xs, ys)
        img, lbl = to_variable(xs), to_variable(ys)
        lbl.stop_gradient = True
        loss_fn(img, lbl)._backward()
        with pytest.raises(RuntimeError, match="manual backward"):
            step(xs, ys)
        mlp.clear_gradients()
        out = step(xs, ys)  # recovers once the tape is cleared
        assert np.isfinite(out.numpy()).all()


def test_fluid_imperative_resolves():
    assert fluid.imperative is imperative
    assert fluid.imperative.F is F
