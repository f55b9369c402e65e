"""The port's host ops and the compiled step's eager path.

* ``print`` passes its input through (and its gradient), prints on the
  first ``first_n`` runs only, ``summarize`` values at most;
* ``layers.py_func`` runs (its ``register_py_func`` import), forward on a
  host copy and, with a backward callable, backward through it: an fc
  trained through a host tanh over 3 SGD steps matches the JAX package
  (losses and state to 1e-5, from the JAX startup state);
* ``delete_var`` drops its inputs from the step's values in both
  packages;
* under ``CompiledProgram`` and ``run_steps`` a program holding a host op
  (``executor.HOST_OPS``: ``print``, ``py_func``, ``tree_conv``,
  ``detection_map``) runs every step eagerly, rows equal to ``Executor.run``'s, counted by
  ``Executor.host_op_steps``, with one warning naming the op; a program
  without one is still captured; ``Switch`` through ``CompiledProgram``
  (captured) equals the JAX package's ``CompiledProgram``;
* ``FetchHandle``, ``CUDAPinnedPlace`` and ``Executor.infer_from_program``
  resolve, and every ``API.spec`` name resolves in the port but those of
  the modules still to port (a list that may only shrink).
"""

import importlib
import pathlib
import warnings

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from test_torch_control_flow import build_switch

PACKAGES = {"jax": jfluid, "torch": tfluid}


def host_tanh(a):
    return np.tanh(a)


def host_tanh_grad(a, g):
    return g * (1.0 - np.tanh(a) ** 2)


def build_py_func(fluid, with_print=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[4, 3], append_batch_size=False)
        h = fluid.layers.fc(x, size=5)
        out = main.global_block.create_var(name="pf_out", shape=[4, 5],
                                           dtype="float32")
        fluid.layers.py_func(host_tanh, h, out, backward_func=host_tanh_grad)
        if with_print:
            out = fluid.layers.Print(out, message="pf", summarize=2)
        loss = fluid.layers.mean(fluid.layers.square(out))
        fluid.optimizer.SGD(0.5).minimize(loss)
    return main, startup, loss


def feed(seed=0):
    return {"x": np.random.RandomState(seed).randn(4, 3).astype("float32")}


def test_py_func_trains_as_the_jax_package_does():
    rows, states = {}, {}
    start = None
    for name, fluid in PACKAGES.items():
        main, startup, loss = build_py_func(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        if name == "jax":
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                exe.run(startup)
            start = {n: np.asarray(v) for n, v in scope.vars.items()}
        else:
            scope = fluid.io.state_from_numpy(main, start, fluid.Scope(),
                                              fluid.CPUPlace())
        with fluid.scope_guard(scope):
            rows[name] = [float(np.asarray(exe.run(
                main, feed=feed(), fetch_list=[loss])[0]).reshape(-1)[0])
                for _ in range(3)]
        states[name] = {n: np.asarray(scope.find_var(n)) for n in start}
    np.testing.assert_allclose(rows["torch"], rows["jax"], rtol=1e-5)
    assert rows["torch"][-1] < rows["torch"][0]
    for n, w in states["jax"].items():
        np.testing.assert_allclose(states["torch"][n], w, rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_print_passes_through_first_n_times(capsys):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[2, 3], append_batch_size=False)
        y = tfluid.layers.scale(tfluid.layers.Print(
            x, message="tap:", first_n=2, summarize=4), scale=2.0)
    exe = tfluid.Executor(tfluid.CPUPlace())
    x_np = np.arange(6, dtype="float32").reshape(2, 3)
    for _ in range(3):
        out, = exe.run(main, feed={"x": x_np}, fetch_list=[y])
        np.testing.assert_array_equal(out, 2 * x_np)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["tap: [0. 1. 2. 3.]"] * 2


def test_delete_var_drops_its_inputs_in_both_packages():
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg
    from test_torch_dense_reduce_math import fake_op

    op = fake_op("delete_var", {}, {"X": [0, 0]}, {})
    for reg in (jreg, treg):
        env = {"X0": 1, "X1": 2, "keep": 3}
        reg.get_op_impl("delete_var")(reg.OpContext(op, env, None))
        assert env == {"keep": 3}


@pytest.mark.parametrize("with_print", (False, True))
def test_compiled_program_runs_host_ops_eagerly_counted(with_print):
    main, startup, loss = build_py_func(tfluid, with_print)
    init = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=init)
    arrays = {n: init.as_numpy(n) for n in init.vars}
    runs = {}
    for mode in ("run", "compiled", "run_steps"):
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.io.state_from_numpy(main, arrays, tfluid.Scope(),
                                           tfluid.CPUPlace())
        main._tpu_step_counter = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if mode == "run_steps":
                rows = exe.run_steps(main, [feed(i) for i in range(4)],
                                     steps=4, fetch_list=[loss],
                                     fetch_every=2, scope=scope)
            else:
                prog = main if mode == "run" else tfluid.CompiledProgram(main)
                rows = [exe.run(prog, feed=feed(i), fetch_list=[loss],
                                scope=scope) for i in range(4)]
        named = [w for w in caught if "'py_func' (block 0, index" in str(
            w.message)]
        runs[mode] = [float(np.asarray(r[0]).reshape(-1)[0]) for r in rows]
        assert exe.host_op_steps == (0 if mode == "run" else 4)
        assert len(named) == (0 if mode == "run" else 1)
    assert runs["compiled"] == runs["run"] == runs["run_steps"]


def test_a_program_without_host_ops_is_still_captured():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4, 3], append_batch_size=False)
        loss = tfluid.layers.mean(tfluid.layers.fc(x, size=2))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run_steps(main, [feed(i) for i in range(4)], steps=4,
                  fetch_list=[loss], scope=scope)
    assert exe.host_op_steps == 0
    cap, = exe._captured.values()
    assert cap.host_op is None and cap.state is not None


def test_switch_compiled_equals_the_jax_package_compiled():
    got = {}
    for name, fluid in PACKAGES.items():
        main, startup, _ = build_switch(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        with fluid.scope_guard(scope), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            exe.run(startup)
            compiled = fluid.CompiledProgram(main)
            got[name] = [float(np.asarray(exe.run(
                compiled, feed={"step": np.asarray([s], "float32")},
                fetch_list=["sw_lr"])[0]).reshape(-1)[0])
                for s in (5.0, 15.0, 25.0)]
    assert got["torch"] == got["jax"]
    np.testing.assert_allclose(got["torch"], [0.1, 0.01, 0.001], rtol=1e-6)


def test_the_missing_names_resolve():
    assert tfluid.FetchHandle is tfluid.executor.FetchHandle
    assert tfluid.CUDAPinnedPlace() == tfluid.CUDAPinnedPlace()
    with pytest.raises(ValueError, match="CUDAPinnedPlace"):
        tfluid.Executor(tfluid.CUDAPinnedPlace())
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[3], append_batch_size=False)
        y = tfluid.layers.scale(x, scale=2.0)
    exe = tfluid.Executor(tfluid.CPUPlace())
    out, = exe.infer_from_program(main, feed={"x": np.ones(3, "float32")},
                                  fetch_list=[y])
    np.testing.assert_array_equal(out, 2 * np.ones(3))


# API.spec names of the reference the port does not have yet, by the
# prefix of the module still to port (ROADMAP Queue 1 item) or the JAX-only
# name. A prefix that no longer matches a missing name must go, and the
# count may only fall.
STILL_TO_PORT = {
    "paddle_tpu.fleet.": "Queue 1 item 8",
    "paddle_tpu.monitor.": "Queue 1 item 8",
    "paddle_tpu.tune.": "Queue 1 item 8",
    "paddle_tpu.profiler.": "Queue 1 item 8",
    "paddle_tpu.reliability.": "Queue 1 item 8",
    "paddle_tpu.serving.": "Queue 1 item 8 (the serving pieces that wait "
                           "for monitor/)",
    "paddle_tpu.parallel.": "Queue 1 item 7",
    # JAX-only names
    "paddle_tpu.inference.": "StableHLO (export_stablehlo, load_stablehlo); "
                             "the port's counterpart is "
                             "inference.export_program",
    "paddle_tpu.compile_cache.": "XLA's on-disk cache (nvcc's build "
                                "directory in the port)",
    "paddle_tpu.is_compiled_with_tpu": "JAX only",
}
JAX_ONLY_SUFFIX = ".jax_device"
MISSING_AT_MOST = 461


def _resolves(name):
    obj, path = tfluid, "paddle_tpu_torch"
    for part in name.split(".")[1:]:
        path += "." + part
        if hasattr(obj, part):
            obj = getattr(obj, part)
            continue
        try:
            obj = importlib.import_module(path)
        except ImportError:
            return False
    return True


def test_api_spec_resolves_but_the_modules_still_to_port():
    spec = pathlib.Path(__file__).resolve().parents[1] / "API.spec"
    names = [line.split(" ", 1)[0] for line in spec.read_text().splitlines()
             if line.strip()]
    missing = [n for n in names if not _resolves(n)]
    unlisted = [n for n in missing if not n.endswith(JAX_ONLY_SUFFIX)
                and not any(n.startswith(p) for p in STILL_TO_PORT)]
    assert not unlisted, unlisted
    stale = [p for p in STILL_TO_PORT
             if not any(n.startswith(p) for n in missing)]
    assert not stale, "ported: take these off STILL_TO_PORT: %s" % stale
    assert len(missing) <= MISSING_AT_MOST, len(missing)
