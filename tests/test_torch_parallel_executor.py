"""The port's script-compatibility modules against the JAX package's:

* ``ParallelExecutor`` (``paddle_tpu_torch/parallel_executor.py``) warns
  ``DeprecationWarning``, counts ``parallel_executor/runs``, equals
  ``Executor.run(CompiledProgram(...).with_data_parallel(...))`` bit for
  bit (losses and state, dropout on), takes ``feed_dict`` as its alias,
  counts the devices of its place's type, and raises with
  ``use_cuda=True`` where there is no GPU;
* the transpiler shims: ``DistributeTranspiler`` returns the program in
  both modes and refuses ``get_pserver_program``; ``memory_optimize`` and
  ``release_memory`` return the program unchanged;
* ``InferenceTranspiler`` folds conv + batch norm as the JAX package's
  does (the folded program's outputs 1e-5, the same op types left);
* ``debugger.pprint_program_codes``, ``draw_block_graphviz``,
  ``contrib.memory_usage`` and ``contrib.op_freq_statistic`` give the JAX
  package's outputs on the same program.
"""

import contextlib
import io
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.monitor import metrics

PACKAGES = {"jax": jfluid, "torch": tfluid}


def build_mlp(fluid, dropout=0.2):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, size=16, act="relu")
        h = fluid.layers.dropout(h, dropout_prob=dropout)
        logits = fluid.layers.fc(h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def build_convbn(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[3, 8, 8])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        c = fluid.layers.conv2d(img, num_filters=4, filter_size=3, padding=1)
        b = fluid.layers.batch_norm(c, act="relu")
        p = fluid.layers.pool2d(b, pool_size=2, pool_stride=2)
        logits = fluid.layers.fc(p, size=5)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        test = main.clone(for_test=True)
        fluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
    return main, startup, test, logits


def mlp_feeds(n):
    rng = np.random.RandomState(1)
    out = []
    for _ in range(n):
        xs = rng.randn(16, 8).astype("float32")
        out.append({"x": xs, "label": (np.abs(xs).sum(1) % 4).astype(
            "int64").reshape(-1, 1)})
    return out


def state_of(main, scope):
    return {v.name: scope.as_numpy(v.name) for v in main.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def test_parallel_executor_equals_the_compiled_program():
    runs = {}
    for kind in ("pe", "compiled"):
        main, startup, loss = build_mlp(tfluid)
        scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        if kind == "pe":
            before = metrics.snapshot().get("parallel_executor/runs", {}).get(
                "value", 0)
            with pytest.warns(DeprecationWarning, match="CompiledProgram"):
                pe = tfluid.ParallelExecutor(False, loss_name=loss.name,
                                             main_program=main, scope=scope)
            assert pe.device_count == 1
            losses = [np.asarray(pe.run([loss], feed_dict=f)[0])
                      for f in mlp_feeds(6)]
            after = metrics.snapshot()["parallel_executor/runs"]["value"]
            assert after - before == 6
            cap, = pe._exe._captured.values()
            assert cap.state is not None  # the captured step ran
        else:
            compiled = tfluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name)
            losses = [np.asarray(exe.run(compiled, feed=f, fetch_list=[loss],
                                         scope=scope)[0])
                      for f in mlp_feeds(6)]
        runs[kind] = (losses, state_of(main, scope))
    (pl, ps), (cl, cs) = runs["pe"], runs["compiled"]
    assert all(np.array_equal(a, b) for a, b in zip(pl, cl))
    assert set(ps) == set(cs)
    assert all(np.array_equal(ps[n], cs[n]) for n in ps)
    assert len({float(np.asarray(v).reshape(-1)[0]) for v in pl}) > 1


def test_parallel_executor_on_the_card_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    main, _, loss = build_mlp(tfluid)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="CUDA"):
            tfluid.ParallelExecutor(True, loss_name=loss.name,
                                    main_program=main)


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_distribute_and_memory_shims(name):
    fluid = PACKAGES[name]
    main, startup, _ = build_mlp(fluid)
    t = fluid.transpiler.DistributeTranspiler()
    assert t.transpile(0, program=main, trainers=2,
                       startup_program=startup) is main
    assert t._mode == "pserver" and t._trainers == 2
    assert t.get_trainer_program() is main
    assert t.get_startup_program() is startup
    with pytest.raises(NotImplementedError, match="parameter-server"):
        t.get_pserver_program("127.0.0.1:6174")
    cfg = fluid.transpiler.DistributeTranspilerConfig()
    cfg.mode = "nccl2"
    t2 = fluid.transpiler.DistributeTranspiler(cfg)
    t2.transpile(1, program=main, trainers="a:1,b:2,c:3",
                 startup_program=startup)
    assert (t2._mode, t2._trainers) == ("collective", 3)
    assert fluid.transpiler.memory_optimize(main) is main
    assert fluid.transpiler.release_memory(main) is main


def test_inference_transpiler_folds_conv_bn_as_the_jax_package():
    rng = np.random.RandomState(5)
    img = rng.randn(4, 3, 8, 8).astype("float32")
    jmain, jstartup, jtest, jlogits = build_convbn(jfluid)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
    # running statistics away from 0 and 1, so the fold does something
    for n in list(jscope.vars):
        if "batch_norm" in n and ("mean" in n or "variance" in n):
            v = np.asarray(jscope.vars[n])
            jscope.set_var(n, (np.abs(rng.randn(*v.shape)) + 0.5).astype(
                "float32"))
    start = {n: np.asarray(v) for n, v in jscope.vars.items()}
    tmain, tstartup, ttest, tlogits = build_convbn(tfluid)
    tscope = tfluid.io.state_from_numpy(tmain, start, tfluid.Scope(),
                                        tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jwant = np.asarray(jexe.run(jtest, feed={"img": img},
                                    fetch_list=[jlogits])[0])
        jfused = jfluid.transpiler.InferenceTranspiler().transpile(
            jtest.clone(), scope=jscope)
        jgot = np.asarray(jexe.run(jfused, feed={"img": img},
                                   fetch_list=[jlogits])[0])
    with tfluid.scope_guard(tscope):
        tfused = tfluid.transpiler.InferenceTranspiler().transpile(
            ttest.clone())
    tgot = texe.run(tfused, feed={"img": img}, fetch_list=[tlogits],
                    scope=tscope)[0]
    jtypes = [op.type for op in jfused.global_block.ops]
    assert "batch_norm" not in jtypes
    assert [op.type for op in tfused.global_block.ops] == jtypes
    np.testing.assert_allclose(jgot, jwant, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgot, jgot, rtol=1e-5, atol=1e-5)


def test_debugger_and_contrib_utils_equal_the_jax_packages(tmp_path):
    got = {}
    for name, fluid in PACKAGES.items():
        main, _, _, _ = build_convbn(fluid)
        with contextlib.redirect_stdout(io.StringIO()) as out:
            text = fluid.debugger.pprint_program_codes(main)
        assert out.getvalue().rstrip("\n") == text
        dot = fluid.debugger.draw_block_graphviz(
            main.global_block, str(tmp_path / ("%s.dot" % name)),
            highlights=["img"])
        got[name] = (text, open(dot).read(),
                     fluid.contrib.memory_usage(main, 32),
                     fluid.contrib.op_freq_statistic(main))
    assert got["torch"] == got["jax"]
    text, dot, mem, (uni, adj) = got["torch"]
    assert "conv2d" in text and dot.startswith("digraph G {")
    assert mem[2] == "KB" and mem[0] < mem[1]
    assert uni["momentum"] == 6 and adj["conv2d->elementwise_add"] == 1
    with pytest.raises(ValueError):
        tfluid.contrib.memory_usage(main, 0)
