"""The port's fake-quantization ops (``ops/quantize_ops.py``), the
``QuantizeTranspiler`` (``contrib/quantize``) and ``contrib/slim`` against
the JAX package's:

* each of the 7 ops forward and backward (``check_op``: outputs 1e-6,
  gradients 1e-5), in training and in test mode, with the window and the
  accumulators as state; a half-way tie rounds to even in both packages
  (0.5 → 0, 1.5 → 2);
* the straight-through gradient (``_STE``): a quant → dequant pair passes
  the gradient through;
* QAT: an MLP transpiled with each activation quantizer trains 3 Adam
  steps equal to the JAX package (losses and state 1e-5, from the JAX
  startup state); ``freeze_program`` puts the weights on the int grid
  and its outputs and ``convert_to_int8``'s int8 weights equal the JAX
  package's;
* slim: the three quantization passes through the pass framework equal
  the transpiler's phases; the pruners, the prune strategy in the
  compressor and the distillation losses equal the JAX package's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.ops import quantize_ops
from test_torch_dense_reduce_math import check_op, randn

PACKAGES = {"jax": jfluid, "torch": tfluid}
TOL = (1e-6, 1e-6)
GRAD_TOL = (1e-5, 1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quantize_abs_max(bits):
    got, want = check_op("fake_quantize_abs_max", {"bit_length": bits},
                         {"X": randn(4, 6, seed=1, scale=3.0)},
                         {"Out": 1, "OutScale": 1}, tol=TOL,
                         grad_tol=GRAD_TOL)
    out = got["Out"].detach().numpy()
    assert np.array_equal(out, np.round(out))


def test_fake_channel_wise_quantize_abs_max():
    check_op("fake_channel_wise_quantize_abs_max", {"bit_length": 8},
             {"X": randn(5, 3, 2, 2, seed=2)}, {"Out": 1, "OutScale": 1},
             tol=TOL, grad_tol=GRAD_TOL)


@pytest.mark.parametrize("is_test", [False, True])
def test_fake_quantize_range_abs_max(is_test):
    window = np.zeros(6, np.float32)
    window[:3] = [0.5, 4.0, 1.0]
    outs = {"Out": 1} if is_test else {"Out": 1, "OutScale": 1,
                                       "OutScales": 1}
    got, _ = check_op(
        "fake_quantize_range_abs_max",
        {"bit_length": 8, "window_size": 6, "is_test": is_test},
        {"X": randn(4, 6, seed=3), "InScale": np.asarray([2.5], np.float32),
         "Iter": np.asarray([8], np.int64), "OutScales": window},
        outs, tol=TOL, grad_tol=GRAD_TOL, diff=["X"])
    if not is_test:  # the step's abs-max lands at slot 8 % 6
        assert float(got["OutScales"][2].detach()) == float(
            np.abs(randn(4, 6, seed=3)).max())


@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("op_type", [
    "fake_quantize_moving_average_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max"])
def test_moving_average_quantizers(op_type, is_test):
    outs = {"Out": 1} if is_test else {"Out": 1, "OutScale": 1,
                                       "OutAccum": 1, "OutState": 1}
    check_op(op_type, {"bit_length": 8, "moving_rate": 0.9,
                       "is_test": is_test},
             {"X": randn(3, 7, seed=4, scale=2.0),
              "InScale": np.asarray([1.5], np.float32),
              "InAccum": np.asarray([2.0], np.float32),
              "InState": np.asarray([1.9], np.float32)},
             outs, tol=TOL, grad_tol=GRAD_TOL, diff=["X"])


def test_fake_dequantize_max_abs():
    check_op("fake_dequantize_max_abs", {"max_range": 127.0},
             {"X": np.round(randn(4, 5, seed=5) * 40),
              "Scale": np.asarray([3.0], np.float32)}, {"Out": 1},
             tol=TOL, grad_tol=GRAD_TOL)


def test_fake_channel_wise_dequantize_max_abs():
    check_op("fake_channel_wise_dequantize_max_abs", {"quant_bits": [8, 8]},
             {"X": np.round(randn(4, 3, 2, seed=6) * 40),
              "Scales": [np.abs(randn(4, seed=7)) + 0.1,
                         np.asarray([2.0], np.float32)]},
             {"Out": 1}, tol=TOL, grad_tol=GRAD_TOL, diff=["X"])


@pytest.mark.parametrize("bits,want", [(2, [0.0, -0.0, 1.0, 0.0]),
                                       (3, [2.0, -2.0, 3.0, 1.0])])
def test_a_half_way_tie_rounds_to_even(bits, want):
    # scale 1 (the abs-max): x / 1 * r is exact, and 0.5 * r is a tie
    x = np.asarray([[0.5, -0.5, 1.0, 0.25]], np.float32)
    got, jax_got = check_op("fake_quantize_abs_max", {"bit_length": bits},
                            {"X": x}, {"Out": 1, "OutScale": 1}, tol=TOL,
                            grad_tol=GRAD_TOL)
    assert got["Out"].detach().numpy().tolist() == [want]
    assert np.asarray(jax_got["Out"]).tolist() == [want]


def test_the_straight_through_gradient():
    x = torch.tensor(randn(5, 5, seed=8), requires_grad=True)
    q, s = quantize_ops.quantize_abs_max(x, 8)
    torch.sum(q * (s.detach() / 127.0) * 2.0).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.full((5, 5), 2.0),
                               rtol=1e-5)
    y = torch.tensor(randn(3, seed=9), requires_grad=True)
    out = quantize_ops._STE.apply(y, torch.zeros(3))
    assert out.tolist() == [0.0, 0.0, 0.0]
    out.sum().backward()
    assert y.grad.tolist() == [1.0, 1.0, 1.0]


# -- QAT through the transpiler ------------------------------------------------

DIM, CLASSES, BATCH = 12, 4, 32


def build_qat(fluid, act_type):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[DIM])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, size=16, act="relu",
                            param_attr=fluid.ParamAttr(name="w0"))
        logits = fluid.layers.fc(h, size=CLASSES,
                                 param_attr=fluid.ParamAttr(name="w1"))
        prob = fluid.layers.softmax(logits)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        t = fluid.contrib.QuantizeTranspiler(
            activation_quantize_type=act_type, window_size=16)
        t.training_transpile(main, startup)
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, test, loss, prob, t


def qat_feeds(n):
    rng = np.random.RandomState(11)
    centers = rng.randn(CLASSES, DIM).astype("float32") * 2
    out = []
    for _ in range(n):
        ys = rng.randint(0, CLASSES, BATCH)
        xs = (centers[ys] + rng.randn(BATCH, DIM)).astype("float32")
        out.append({"x": xs, "y": ys.reshape(-1, 1).astype("int64")})
    return out


def _state(main, scope):
    return {v.name: np.array(scope.as_numpy(v.name)) for v in main.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


@pytest.mark.parametrize("act_type", ["abs_max", "moving_average_abs_max",
                                      "range_abs_max"])
def test_qat_trains_freezes_and_converts_as_the_jax_package(act_type):
    feeds = qat_feeds(3)
    jmain, jstartup, jtest, jloss, jprob, jt = build_qat(jfluid, act_type)
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        start = {n: np.asarray(v) for n, v in jscope.vars.items()}
        jl = [float(jexe.run(jmain, feed=f, fetch_list=[jloss])[0])
              for f in feeds]
        want = _state(jmain, jscope)
        jfloat = {w: np.array(want[w]) for w in ("w0", "w1")}
        jt.freeze_program(jtest)
        jfrozen = np.asarray(jexe.run(jtest, feed=feeds[0],
                                      fetch_list=[jprob])[0])
        jconv = jt.convert_to_int8(jtest)
    tmain, tstartup, ttest, tloss, tprob, tt = build_qat(tfluid, act_type)
    qops = [op.type for op in tmain.global_block.ops
            if op.type.startswith("fake_")]
    assert len(qops) >= 8, qops
    assert qops == [op.type for op in jmain.global_block.ops
                    if op.type.startswith("fake_")]
    tscope = tfluid.io.state_from_numpy(tmain, start, tfluid.Scope(),
                                        tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tscope):
        tl = [float(texe.run(tmain, feed=f, fetch_list=[tloss])[0])
              for f in feeds]
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        got = _state(tmain, tscope)
        for n in want:
            np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-5,
                                       err_msg=n)
        tt.freeze_program(ttest)
        for w in ("w0", "w1"):
            v = tscope.as_numpy(w)
            assert np.array_equal(v, np.round(v)) and np.abs(v).max() <= 127
            grid = np.round(jfloat[w] / np.abs(jfloat[w]).max() * 127)
            assert np.abs(v - grid).max() <= 1.0
        assert [op.type for op in ttest.global_block.ops] == \
            [op.type for op in jtest.global_block.ops]
        tfrozen = texe.run(ttest, feed=feeds[0], fetch_list=[tprob])[0]
        np.testing.assert_allclose(tfrozen, jfrozen, rtol=1e-5, atol=1e-5)
        tconv = tt.convert_to_int8(ttest)
    assert sorted(tconv) == sorted(jconv) == ["w0", "w1"]
    for w in tconv:
        t = tscope.find_var(w)
        assert t.dtype == torch.int8 and t.device.type == "cpu"
        # the weights JAX froze may sit one level off where a step's float32
        # rounding differed; the grids agree elsewhere
        assert np.abs(t.numpy().astype(int)
                      - np.asarray(jscope.find_var(w)).astype(int)).max() <= 1


# -- slim -------------------------------------------------------------------------


def test_the_quantization_passes_equal_the_transpiler_phases():
    runs = {}
    for kind in ("passes", "transpiler"):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", shape=[DIM])
            out = tfluid.layers.fc(x, size=CLASSES,
                                   param_attr=tfluid.ParamAttr(name="w"))
        scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        if kind == "passes":
            tfluid.get_pass("quantization_transform_pass").apply(
                main, startup_program=startup)
        else:
            t = tfluid.contrib.QuantizeTranspiler()
            t.training_transpile(main, startup)
        exe.run(startup, scope=scope)
        test = main.clone(for_test=True)
        if kind == "passes":
            tfluid.get_pass("quantization_freeze_pass").set_attr(
                "scope", scope).apply(test)
            pass_ = tfluid.get_pass("convert_to_int8_pass").set_attr(
                "scope", scope)
            assert pass_.apply(test) is test
            conv = pass_.converted
        else:
            t.freeze_program(test, scope=scope)
            conv = t.convert_to_int8(test, scope=scope)
        runs[kind] = ([op.type for op in main.global_block.ops],
                      [op.type for op in test.global_block.ops], conv,
                      scope.as_numpy("w"))
    (a, b, c, d), (e, f, g, h) = runs["passes"], runs["transpiler"]
    assert (a, b, c) == (e, f, g) and "fake_quantize_abs_max" in a
    assert d.dtype == np.int8 and np.array_equal(d, h)


def test_pruners_and_the_prune_strategy_equal_the_jax_packages():
    v = np.array([[0.1, -0.9], [0.5, -0.05]], "float32")
    for fluid in PACKAGES.values():
        slim = fluid.contrib.slim
        mask = slim.RatioPruner({"*": 0.5}).prune(v, name="w")
        assert mask.sum() == 2 and mask[0, 1] == 1 and mask[1, 0] == 1
        np.testing.assert_array_equal(slim.MagnitudePruner(0.4).prune(v),
                                      (np.abs(v) >= 0.4).astype("float32"))
    got = {}
    for name, fluid in PACKAGES.items():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[8])
            y = fluid.layers.fc(x, size=4, bias_attr=False,
                                param_attr=fluid.ParamAttr(name="w"))
            loss = fluid.layers.mean(fluid.layers.square(y))
            fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
        scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
        w0 = np.random.RandomState(12).randn(8, 4).astype("float32")
        with fluid.scope_guard(scope):
            exe.run(startup)
            if name == "jax":
                scope.set_var("w", w0)
            else:
                scope.set_var("w", torch.tensor(w0))
            feeds = [{"x": np.random.RandomState(13 + i).randn(4, 8)
                      .astype("float32")} for i in range(3)]
            ctx = fluid.contrib.slim.build_compressor(
                data_reader=lambda: iter(feeds), epoch=2, program_exe=exe,
                strategies=[fluid.contrib.slim.PruneStrategy(
                    fluid.contrib.slim.RatioPruner({"*": 0.25}),
                    start_epoch=0, end_epoch=10)]).apply(main)
            assert ctx.epoch_id == 1 and ctx.batch_id == 3
            got[name] = np.asarray(scope.as_numpy("w"))
    assert (got["torch"] == 0).mean() >= 0.70
    np.testing.assert_array_equal(got["torch"] == 0, got["jax"] == 0)
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-6,
                               atol=1e-7)


def test_distillation_losses_equal_the_jax_packages():
    rng = np.random.RandomState(14)
    n = 3
    feed = {"t": rng.randn(n, 6).astype("float32"),
            "s": rng.randn(n, 6).astype("float32"),
            "ta": rng.randn(n, 3, 4, 4).astype("float32"),
            "tb": rng.randn(n, 5, 4, 4).astype("float32"),
            "sa": rng.randn(n, 3, 4, 4).astype("float32"),
            "sb": rng.randn(n, 5, 4, 4).astype("float32")}
    got = {}
    for name, fluid in PACKAGES.items():
        d = fluid.contrib.slim.distillation
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            t = fluid.layers.data("t", shape=[6])
            s = fluid.layers.data("s", shape=[6])
            maps = {k: fluid.layers.data(k, shape=list(feed[k].shape[1:]))
                    for k in ("ta", "tb", "sa", "sb")}
            outs = [d.soft_label_loss(t, s, temperature=2.0),
                    d.l2_distill_loss(t, s),
                    d.fsp_loss(maps["ta"], maps["tb"], maps["sa"],
                               maps["sb"])]
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            got[name] = [float(np.asarray(v).reshape(-1)[0]) for v in
                         exe.run(main, feed=feed, fetch_list=outs)]
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-5)
    assert isinstance(tfluid.contrib.slim.distillation.DistillationStrategy(),
                      tfluid.contrib.slim.Strategy)
