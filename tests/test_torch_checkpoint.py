"""The port's rotating checkpoints (``io.save_checkpoint``,
``load_checkpoint``, ``clean_checkpoint``) against the JAX package's
(``paddle_tpu/io.py:258-429``), at test width on the CPU:

* rotation keeps the newest ``max_num_checkpoints`` serials, and the
  layout is the JAX package's (``checkpoint_<serial>/``, the
  ``save_persistables`` files, ``trainer_args.json``, ``_SUCCESS``);
* a serial without ``_SUCCESS`` is skipped, a ``_SUCCESS``-marked one with
  a truncated tensor file falls back to the serial before it, a fault at
  ``io.save_checkpoint`` leaves an unpublished staging dir that is
  skipped, and no checkpoint returns None;
* a resume (new program, scope and executor; the step counter set from
  ``trainer_args``) is bit-equal to uninterrupted training with dropout
  on, eagerly and through ``ParallelExecutor`` (a captured step), also
  when the load lands in a scope whose step is already captured (by
  ``io.load_vars``, restored into the same captured step, and by
  ``load_checkpoint``, captured anew);
* a checkpoint of the JAX package loads in the port and trains on equal
  to the JAX package (1e-6), and the other way round;
* the AMP program's persistables hold no bfloat16 (``save_vars`` raises
  on one), so its checkpoint saves.
"""

import json
import os
import warnings

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.reliability import faults

DIM, CLASSES, BATCH = 8, 3, 16


def build(fluid, dropout=0.0, amp=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 90210
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[DIM])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, size=16, act="relu",
                            param_attr=fluid.ParamAttr(name="w0"),
                            bias_attr=fluid.ParamAttr(name="b0"))
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=dropout)
        logits = fluid.layers.fc(h, size=CLASSES,
                                 param_attr=fluid.ParamAttr(name="w"),
                                 bias_attr=fluid.ParamAttr(name="b"))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        opt = fluid.optimizer.Adam(0.01)
        if amp:
            opt = fluid.amp.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(BATCH, DIM).astype("float32"),
             "y": rng.randint(0, CLASSES, (BATCH, 1)).astype("int64")}
            for _ in range(n)]


def persistables(fluid, main, scope):
    return {v.name: np.array(scope.as_numpy(v.name))
            for v in main.list_vars() if v.persistable and not v.is_data
            and scope.find_var(v.name) is not None}


def port_run(main, startup, loss, steps, scope, exe, start=0):
    with tfluid.scope_guard(scope):
        return [float(exe.run(main, feed=f, fetch_list=[loss])[0])
                for f in feeds(start + steps)[start:]]


def test_rotation_serials_and_layout(tmp_path):
    ckpt = str(tmp_path / "ck")
    main, startup, loss = build(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    with tfluid.scope_guard(scope):
        for step, f in enumerate(feeds(5)):
            exe.run(main, feed=f, fetch_list=[loss])
            serial = tfluid.io.save_checkpoint(
                exe, ckpt, main, trainer_args={"step": step},
                max_num_checkpoints=3)
            assert serial == step
        assert sorted(os.listdir(ckpt)) == [
            "checkpoint_2", "checkpoint_3", "checkpoint_4"]
        files = set(os.listdir(os.path.join(ckpt, "checkpoint_4")))
        assert {"_SUCCESS", "trainer_args.json", "__index__.json",
                "w.npy"} <= files
        with open(os.path.join(ckpt, "checkpoint_4", "trainer_args.json")) as f:
            assert json.load(f) == {"trainer_id": 0, "step": 4}
        assert tfluid.io.load_checkpoint(exe, ckpt, main)["step"] == 4
        assert tfluid.io.load_checkpoint(exe, ckpt, main, serial=2)["step"] == 2
        tfluid.io.clean_checkpoint(ckpt, delete_dir=True)
    assert not os.path.exists(ckpt)
    cfg = tfluid.io.CheckpointConfig(str(tmp_path), max_num_checkpoints=2)
    assert (cfg.checkpoint_dir, cfg.max_num_checkpoints,
            cfg.step_interval) == (str(tmp_path), 2, 10)


def _trained(tmp_path):
    ckpt = str(tmp_path / "ck")
    main, startup, loss = build(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    port_run(main, startup, loss, 1, scope, exe)
    with tfluid.scope_guard(scope):
        tfluid.io.save_checkpoint(exe, ckpt, main, trainer_args={"step": 1})
    good = persistables(tfluid, main, scope)
    port_run(main, startup, loss, 1, scope, exe, start=1)  # drift
    return ckpt, main, exe, scope, good


def test_unmarked_serial_is_skipped(tmp_path):
    ckpt, main, exe, scope, good = _trained(tmp_path)
    torn = os.path.join(ckpt, "checkpoint_1")
    os.makedirs(torn)
    with open(os.path.join(torn, "garbage"), "w") as f:
        f.write("x")
    with tfluid.scope_guard(scope):
        assert tfluid.io.load_checkpoint(exe, ckpt, main)["step"] == 1
    got = persistables(tfluid, main, scope)
    assert all(np.array_equal(got[n], good[n]) for n in good)


def test_torn_success_serial_falls_back(tmp_path):
    ckpt, main, exe, scope, good = _trained(tmp_path)
    with tfluid.scope_guard(scope):
        tfluid.io.save_checkpoint(exe, ckpt, main, trainer_args={"step": 2})
    w = os.path.join(ckpt, "checkpoint_1", "w.npy")
    with open(w, "r+b") as f:  # a truncated payload under a _SUCCESS mark
        f.truncate(40)
    with tfluid.scope_guard(scope):
        assert tfluid.io.load_checkpoint(exe, ckpt, main)["step"] == 1
    got = persistables(tfluid, main, scope)
    assert all(np.array_equal(got[n], good[n]) for n in good)
    os.remove(os.path.join(ckpt, "checkpoint_0", "w.npy"))
    with tfluid.scope_guard(scope), pytest.raises(
            RuntimeError, match="no readable checkpoint"):
        tfluid.io.load_checkpoint(exe, ckpt, main)


def test_fault_at_the_save_site_leaves_a_skipped_serial(tmp_path):
    ckpt, main, exe, scope, good = _trained(tmp_path)
    faults.install(faults.FaultPlan.parse("io.save_checkpoint@1=fatal"))
    try:
        with tfluid.scope_guard(scope), pytest.raises(faults.InjectedFault):
            tfluid.io.save_checkpoint(exe, ckpt, main,
                                      trainer_args={"step": 2})
    finally:
        faults.clear()
    names = sorted(os.listdir(ckpt))
    assert names[0] == "checkpoint_0" and names[1].startswith(
        "checkpoint_1.tmp.0.")
    with tfluid.scope_guard(scope):
        assert tfluid.io.load_checkpoint(exe, ckpt, main)["step"] == 1
        # the next save takes serial 1, the staging dir is no serial
        assert tfluid.io.save_checkpoint(exe, ckpt, main) == 1


def test_no_checkpoint_returns_none(tmp_path):
    main, _, _ = build(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    assert tfluid.io.load_checkpoint(exe, str(tmp_path / "no"), main) is None
    tfluid.io.clean_checkpoint(str(tmp_path / "no"))  # no-op, no raise


def _resume_runs(tmp_path, run):
    """(uninterrupted losses and state, resumed losses and state) of 6
    steps with dropout 0.3, the resume a new program, scope and executor
    after 3 steps and a checkpoint; ``run(main, loss, exe_or_pe, scope,
    feed)`` takes one step."""
    ckpt = str(tmp_path / "ck")
    data = feeds(6)
    main, startup, loss = build(tfluid, dropout=0.3)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    start = persistables(tfluid, main, scope)
    runner = run(main, loss, scope)
    full = [runner(f) for f in data]
    full_state = persistables(tfluid, main, scope)

    main1, startup1, loss1 = build(tfluid, dropout=0.3)
    scope1 = tfluid.Scope()
    exe1 = tfluid.Executor(tfluid.CPUPlace())
    tfluid.io.state_from_numpy(main1, start, scope1, tfluid.CPUPlace())
    runner1 = run(main1, loss1, scope1)
    part = [runner1(f) for f in data[:3]]
    with tfluid.scope_guard(scope1):
        tfluid.io.save_checkpoint(exe1, ckpt, main1, trainer_args={"step": 3})

    main2, startup2, loss2 = build(tfluid, dropout=0.3)
    scope2 = tfluid.Scope()
    exe2 = tfluid.Executor(tfluid.CPUPlace())
    exe2.run(startup2, scope=scope2)  # other weights, then the restore
    with tfluid.scope_guard(scope2):
        args = tfluid.io.load_checkpoint(exe2, ckpt, main2)
    main2._tpu_step_counter = args["step"]
    runner2 = run(main2, loss2, scope2)
    rest = [runner2(f) for f in data[3:]]
    return (full, full_state), (part + rest,
                                persistables(tfluid, main2, scope2)), ckpt


def _executor(main, loss, scope):
    exe = tfluid.Executor(tfluid.CPUPlace())
    return lambda f: float(exe.run(main, feed=f, fetch_list=[loss],
                                   scope=scope)[0])


def _parallel(main, loss, scope):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        pe = tfluid.ParallelExecutor(False, loss_name=loss.name,
                                     main_program=main, scope=scope)
    return lambda f: float(np.asarray(pe.run([loss], feed=f)[0]).reshape(-1)[0])


@pytest.mark.parametrize("run", [_executor, _parallel],
                         ids=["executor", "parallel_executor"])
def test_resume_is_bit_equal_with_dropout(tmp_path, run):
    (full, full_state), (resumed, state), _ = _resume_runs(tmp_path, run)
    assert resumed == full
    assert set(state) == set(full_state)
    for n in full_state:
        assert np.array_equal(state[n], full_state[n]), n
    assert full[0] != full[1]  # dropout draws anew every step


@pytest.mark.parametrize("load", ["load_vars", "load_checkpoint"])
def test_load_into_a_captured_scope_reaches_the_next_step(tmp_path, load):
    """After ``ParallelExecutor`` captured its step (the scope's tensors are
    its static state), a checkpoint loaded into that scope is what the
    next steps read: with the counter set back, they repeat steps 4-6.
    ``io.load_vars`` of the checkpoint's files leaves the program and its
    captured step as they are, whose next step copies the loaded tensors
    into its static state (``_CapturedStep._restore_state``);
    ``load_checkpoint`` bumps the program's version, so the next step is a
    new captured step's warm-up."""
    (full, full_state), _, ckpt = _resume_runs(tmp_path, _parallel)
    main, startup, loss = build(tfluid, dropout=0.3)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        pe = tfluid.ParallelExecutor(False, loss_name=loss.name,
                                     main_program=main, scope=scope)
    for f in feeds(4):
        pe.run([loss], feed=f)
    cap, = pe._exe._captured.values()
    assert cap.state is not None
    held = dict(cap.state)
    with tfluid.scope_guard(scope):
        if load == "load_vars":
            tfluid.io.load_vars(exe, os.path.join(ckpt, "checkpoint_0"))
            args = {"step": 3}
        else:
            args = tfluid.io.load_checkpoint(exe, ckpt, main)
    assert scope.find_var("w") is not held["w"]
    main._tpu_step_counter = args["step"]
    again = [float(np.asarray(pe.run([loss], feed=f)[0]).reshape(-1)[0])
             for f in feeds(6)[3:]]
    assert again == full[3:]
    if load == "load_vars":  # the same captured step, its tensors restored
        assert list(pe._exe._captured.values()) == [cap]
        assert all(scope.find_var(n) is t for n, t in held.items())
    else:
        assert len(pe._exe._captured) == 2
    state = persistables(tfluid, main, scope)
    assert all(np.array_equal(state[n], full_state[n]) for n in full_state)


def _jax_trained(steps, scope):
    main, startup, loss = build(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        losses = [float(exe.run(main, feed=f, fetch_list=[loss])[0])
                  for f in feeds(steps)]
    return main, exe, loss, losses


def test_a_jax_checkpoint_trains_on_in_the_port(tmp_path):
    ckpt = str(tmp_path / "ck")
    jscope = jfluid.Scope()
    jmain, jexe, jloss, _ = _jax_trained(3, jscope)
    with jfluid.scope_guard(jscope):
        jfluid.io.save_checkpoint(jexe, ckpt, jmain, trainer_args={"step": 3})
        jrest = [float(jexe.run(jmain, feed=f, fetch_list=[jloss])[0])
                 for f in feeds(6)[3:]]
    main, startup, loss = build(tfluid)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    with tfluid.scope_guard(scope):
        assert tfluid.io.load_checkpoint(exe, ckpt, main)["step"] == 3
    rest = port_run(main, startup, loss, 3, scope, exe, start=3)
    np.testing.assert_allclose(rest, jrest, rtol=1e-6)
    want = persistables(jfluid, jmain, jscope)
    got = persistables(tfluid, main, scope)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-6, atol=1e-7,
                                   err_msg=n)


def test_a_port_checkpoint_trains_on_in_the_jax_package(tmp_path):
    ckpt = str(tmp_path / "ck")
    jscope = jfluid.Scope()
    jmain, jexe, jloss, _ = _jax_trained(0, jscope)
    start = {n: np.asarray(v) for n, v in jscope.vars.items()}
    main, startup, loss = build(tfluid)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    tfluid.io.state_from_numpy(main, start, scope, tfluid.CPUPlace())
    port_run(main, startup, loss, 3, scope, exe)
    with tfluid.scope_guard(scope):
        tfluid.io.save_checkpoint(exe, ckpt, main, trainer_args={"step": 3})
    rest = port_run(main, startup, loss, 3, scope, exe, start=3)
    with jfluid.scope_guard(jscope):
        assert jfluid.io.load_checkpoint(jexe, ckpt, jmain)["step"] == 3
        jrest = [float(jexe.run(jmain, feed=f, fetch_list=[jloss])[0])
                 for f in feeds(6)[3:]]
    np.testing.assert_allclose(rest, jrest, rtol=1e-6)
    want = persistables(jfluid, jmain, jscope)
    got = persistables(tfluid, main, scope)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-6, atol=1e-7,
                                   err_msg=n)


def test_the_amp_program_checkpoints_without_bfloat16(tmp_path):
    main, startup, loss = build(tfluid, dropout=0.1, amp=True)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    port_run(main, startup, loss, 2, scope, exe)
    dtypes = {str(scope.find_var(v.name).dtype) for v in main.list_vars()
              if v.persistable and scope.find_var(v.name) is not None}
    assert "torch.bfloat16" not in dtypes, dtypes
    with tfluid.scope_guard(scope):
        tfluid.io.save_checkpoint(exe, str(tmp_path / "ck"), main,
                                  trainer_args={"step": 2})
        assert tfluid.io.load_checkpoint(
            exe, str(tmp_path / "ck"), main)["step"] == 2
