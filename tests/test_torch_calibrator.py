"""The port's post-training int8 ``Calibrator``
(``contrib/int8_inference/calibrator.py``) against the JAX package's:
from the same trained fp32 weights (the JAX package's, carried by
``io.state_from_numpy``) and the same calibration batches, the
``abs_max`` and ``KL`` scales agree to 1e-4 relative, the calibrated
programs' outputs agree and track fp32's argmax, the weights land on the
int grid, ``save_int8_model`` writes a model that loads back (in the
port and in the JAX package) and predicts, and ``calibrate`` before any
``sample_data`` raises."""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

PACKAGES = {"jax": jfluid, "torch": tfluid}


def build(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[16])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, size=32, act="relu")
        logits = fluid.layers.fc(h, size=4)
        prob = fluid.layers.softmax(logits)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return main, startup, test, prob, loss


def data():
    rng = np.random.RandomState(21)
    w = rng.randn(16, 4)
    xs = rng.randn(256, 16).astype("float32")
    ys = np.argmax(xs @ w, axis=1).reshape(-1, 1).astype("int64")
    return xs, ys


@pytest.fixture(scope="module")
def trained():
    """The JAX package's weights after 20 Adam steps."""
    xs, ys = data()
    main, startup, _, _, loss = build(jfluid)
    scope, exe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(20):
            exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
    return {n: np.asarray(v) for n, v in scope.vars.items()}


def calibrated(fluid, state, algo):
    xs, ys = data()
    main, _, test, prob, _ = build(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    if fluid is tfluid:
        tfluid.io.state_from_numpy(main, state, scope, tfluid.CPUPlace())
    else:
        for n, v in state.items():
            scope.set_var(n, v)
    with fluid.scope_guard(scope):
        fp32 = np.asarray(exe.run(test, feed={"x": xs[:64], "y": ys[:64]},
                                  fetch_list=[prob])[0])
        calib = fluid.contrib.Calibrator(test, exe, algo=algo)
        for i in range(0, 256, 64):
            calib.sample_data({"x": xs[i:i + 64], "y": ys[i:i + 64]})
        scales = calib._scales()
        qprog = calib.calibrate()
        q = np.asarray(exe.run(qprog, feed={"x": xs[:64], "y": ys[:64]},
                               fetch_list=[prob])[0])
    return scales, fp32, q, scope, calib, qprog


@pytest.mark.parametrize("algo", ["abs_max", "KL"])
def test_scales_and_outputs_equal_the_jax_packages(trained, algo):
    ts, tfp32, tq, tscope, _, tprog = calibrated(tfluid, trained, algo)
    js, jfp32, jq, jscope, _, jprog = calibrated(jfluid, trained, algo)
    assert sorted(ts) == sorted(js) and len(ts) == 2
    for n in js:
        np.testing.assert_allclose(ts[n], js[n], rtol=1e-4, err_msg=n)
    np.testing.assert_allclose(tfp32, jfp32, rtol=1e-5, atol=1e-6)
    assert [op.type for op in tprog.global_block.ops] == \
        [op.type for op in jprog.global_block.ops]
    np.testing.assert_allclose(tq, jq, rtol=1e-4, atol=1e-5)
    assert (np.argmax(tq, 1) == np.argmax(tfp32, 1)).mean() >= 0.95
    for p in ("fc_0.w_0", "fc_1.w_0"):
        w = tscope.as_numpy(p)
        assert np.array_equal(w, np.round(w)) and np.abs(w).max() <= 127
        assert np.abs(w - np.asarray(jscope.find_var(p))).max() <= 1.0


def test_save_int8_model_loads_back(trained, tmp_path):
    xs, _ = data()
    _, _, _, scope, calib, _ = calibrated(tfluid, trained, "abs_max")
    prob_name, = [op.output_arg_names[0] for op in
                  calib.program.global_block.ops if op.type == "softmax"]
    out_dir = str(tmp_path / "int8")
    calib.save_int8_model(out_dir, ["x"], [prob_name])
    assert scope.find_var("fc_0.w_0").dtype == torch.int8
    outs = {}
    for name, fluid in PACKAGES.items():
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            prog, feeds, fetches = fluid.io.load_inference_model(out_dir, exe)
            assert feeds == ["x"] and fetches == [prob_name]
            w = fluid.global_scope().find_var("fc_0.w_0")
            assert str(np.asarray(w).dtype) == "int8"
            outs[name] = np.asarray(exe.run(prog, feed={"x": xs[:8]},
                                            fetch_list=fetches)[0])
    assert outs["torch"].shape == (8, 4)
    assert np.isfinite(outs["torch"]).all()
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=1e-5,
                               atol=1e-6)


def test_calibrate_needs_samples(trained):
    main, _, test, _, _ = build(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(RuntimeError, match="sample_data"):
        tfluid.contrib.Calibrator(test, exe).calibrate()
    with pytest.raises(ValueError, match="algo"):
        tfluid.contrib.Calibrator(test, exe, algo="mse")
