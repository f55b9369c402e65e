"""The port's control flow matches the JAX package's.

The seven cases of ``tests/test_control_flow.py``, each program built by
both packages (``import paddle_tpu as fluid`` and ``import
paddle_tpu_torch as fluid``) and run on the CPU from the same feeds and,
where it has parameters, the JAX startup state carried over by
``io.state_from_numpy``: ``While`` sums, the missing condition update,
``cond``, ``StaticRNN`` accumulating and training (losses and state to
1e-5 over 5 steps), ``IfElse`` and ``Switch``'s first match. Also held:

* the gradient through a ``while``, as in the JAX package: a loss that
  reads a carry depending on a parameter raises ``ValueError`` (JAX's
  ``lax.while_loop`` has no reverse rule), a loss that does not read it
  trains, with the JAX package's losses;
* a ``while`` carrying a TensorArray never written before it raises;
* ``conditional_block`` runs only the branch its predicate selects;
* the layers' ``ValueError``/``TypeError`` messages equal the JAX
  layers';
* the captured step captures a ``conditional_block`` program (both
  branches, selected on the device), with the JAX package's
  ``CompiledProgram`` rates and no step counted eager.
"""

import warnings

import numpy as np
import pytest

import chip_smoke
import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

PACKAGES = {"jax": jfluid, "torch": tfluid}


def guard(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    return main, startup


def run_both(build, feeds, fetch_names, steps=1):
    """``build(fluid)`` -> (main, startup, fetch vars) in both packages;
    the JAX startup state carried into the port's scope; ``steps`` runs
    each over ``feeds``. Returns {package: [rows]} and the two scopes'
    final states."""
    out, states = {}, {}
    start = None
    for name, fluid in PACKAGES.items():
        main, startup, fetch = build(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        if name == "jax":
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                exe.run(startup)
            start = {n: np.asarray(v) for n, v in scope.vars.items()}
        else:
            scope = fluid.io.state_from_numpy(main, start, fluid.Scope(),
                                              fluid.CPUPlace())
        rows = []
        with fluid.scope_guard(scope):
            for f in feeds[:steps] if len(feeds) >= steps else feeds * steps:
                rows.append([np.asarray(v) for v in exe.run(
                    main, feed=f, fetch_list=fetch)])
        out[name] = rows
        states[name] = {n: np.asarray(scope.find_var(n)) for n in start}
    return out, states


def assert_rows_equal(out, rtol=1e-5, atol=1e-6):
    assert len(out["jax"]) == len(out["torch"])
    for want, got in zip(out["jax"], out["torch"]):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def build_while_sums(fluid):
    main, startup = guard(fluid)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        i = fluid.layers.fill_constant([1], "int32", 0)
        n = fluid.layers.fill_constant([1], "int32", 10)
        s = fluid.layers.fill_constant([1], "float32", 0.0)
        cond = fluid.layers.less_than(i, n)
        w = fluid.layers.While(cond)
        with w.block():
            fluid.layers.assign(fluid.layers.cast(i, "float32") + s, s)
            fluid.layers.increment(i, value=1, in_place=True)
            fluid.layers.less_than(i, n, cond=cond)
    return main, startup, [s, i]


def test_while_loop_sums():
    out, _ = run_both(build_while_sums, [{}], None)
    assert_rows_equal(out, rtol=0, atol=0)
    s, i = out["torch"][0]
    assert float(s.item()) == sum(range(10)) and int(i.item()) == 10
    assert i.dtype == np.int32


def layer_error(fluid, case):
    """The message of the error a layer raises for ``case``."""
    main, startup = guard(fluid)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        i = fluid.layers.fill_constant([1], "int32", 0)
        n = fluid.layers.fill_constant([1], "int32", 10)
        x = fluid.layers.fill_constant([2, 3], "float32", 1.0)
        try:
            if case == "while_no_update":
                w = fluid.layers.While(fluid.layers.less_than(i, n))
                with w.block():
                    fluid.layers.increment(i, in_place=True)
            elif case == "while_not_bool":
                fluid.layers.While(i)
            elif case == "cond_no_false_fn":
                fluid.layers.cond(fluid.layers.less_than(i, n),
                                  lambda: fluid.layers.scale(x, 2.0))
            elif case == "cond_arity":
                fluid.layers.cond(fluid.layers.less_than(i, n),
                                  lambda: (x, x), lambda: x)
            elif case == "rnn_memory_no_init":
                rnn = fluid.layers.StaticRNN()
                with rnn.step():
                    rnn.memory(shape=[3])
            elif case == "rnn_never_updated":
                rnn = fluid.layers.StaticRNN()
                xs = fluid.layers.fill_constant([4, 2, 3], "float32", 1.0)
                with rnn.step():
                    rnn.step_input(xs)
                    rnn.memory(init=x)
            elif case == "rnn_update_unknown":
                rnn = fluid.layers.StaticRNN()
                xs = fluid.layers.fill_constant([4, 2, 3], "float32", 1.0)
                with rnn.step():
                    w = rnn.step_input(xs)
                    rnn.update_memory(w, w)
            elif case == "ifelse_input_outside":
                fluid.layers.IfElse(fluid.layers.less_than(i, n)).input(x)
            elif case == "ifelse_nested":
                ie = fluid.layers.IfElse(fluid.layers.less_than(i, n))
                with ie.true_block():
                    with ie.false_block():
                        pass
            elif case == "ifelse_call_without_blocks":
                fluid.layers.IfElse(fluid.layers.less_than(i, n))()
            elif case == "switch_nested":
                with fluid.layers.Switch() as switch:
                    with switch.case(fluid.layers.less_than(i, n)):
                        with switch.default():
                            pass
        except (ValueError, TypeError) as e:
            return type(e).__name__, str(e)
    return None


LAYER_ERRORS = ("while_no_update", "while_not_bool", "cond_no_false_fn",
                "cond_arity", "rnn_memory_no_init", "rnn_never_updated",
                "rnn_update_unknown", "ifelse_input_outside",
                "ifelse_nested", "ifelse_call_without_blocks",
                "switch_nested")


@pytest.mark.parametrize("case", LAYER_ERRORS)
def test_layer_errors_are_the_jax_layers(case):
    want = layer_error(jfluid, case)
    assert want is not None
    # var names come from the name generator, equal in both packages
    assert layer_error(tfluid, case) == want


def test_while_requires_condition_update():
    kind, msg = layer_error(tfluid, "while_no_update")
    assert kind == "ValueError" and "infinite loop" in msg


def build_cond(fluid):
    main, startup = guard(fluid)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[2])
        flag = fluid.layers.data("flag", shape=[], dtype="bool",
                                 append_batch_size=False)
        out = fluid.layers.cond(
            flag,
            lambda: fluid.layers.scale(x, scale=2.0),
            lambda: fluid.layers.scale(x, scale=-1.0),
        )
    return main, startup, [out]


def test_cond_branches():
    xs = np.random.RandomState(0).randn(3, 2).astype("float32")
    feeds = [{"x": xs, "flag": np.array(True)},
             {"x": xs, "flag": np.array(False)}]
    out, _ = run_both(build_cond, feeds, None, steps=2)
    assert_rows_equal(out, rtol=0, atol=0)
    np.testing.assert_allclose(out["torch"][0][0], 2 * xs, rtol=1e-6)
    np.testing.assert_allclose(out["torch"][1][0], -xs, rtol=1e-6)


def test_conditional_block_runs_only_the_selected_branch():
    """The false branch reshapes [3, 2] to [7, 7], which fails when it
    runs; with the predicate true it must not run."""
    main, startup = guard(tfluid)
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", shape=[2])
        flag = tfluid.layers.data("flag", shape=[], dtype="bool",
                                  append_batch_size=False)
        out = tfluid.layers.cond(
            flag, lambda: tfluid.layers.scale(x, scale=2.0),
            lambda: tfluid.layers.reshape(x, [7, 7]))
    exe = tfluid.Executor(tfluid.CPUPlace())
    xs = np.ones((3, 2), np.float32)
    got, = exe.run(main, feed={"x": xs, "flag": np.array(True)},
                   fetch_list=[out], scope=tfluid.Scope())
    np.testing.assert_array_equal(got, 2 * xs)
    with pytest.raises(Exception, match="reshape"):
        exe.run(main, feed={"x": xs, "flag": np.array(False)},
                fetch_list=[out], scope=tfluid.Scope())


T, B, D, H = 5, 3, 4, 5


def build_static_rnn_sum(fluid):
    main, startup = guard(fluid)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x_tm = fluid.layers.data("x_tm", shape=[T, B, D],
                                 append_batch_size=False)
        h0 = fluid.layers.fill_constant([B, D], "float32", 0.0)
        rnn = fluid.layers.StaticRNN()
        with rnn.step():
            w = rnn.step_input(x_tm)
            prev = rnn.memory(init=h0)
            nxt = fluid.layers.elementwise_add(w, prev)
            rnn.update_memory(prev, nxt)
            rnn.step_output(nxt)
        outs = rnn()
    return main, startup, [outs] + list(rnn.final_states)


def test_static_rnn_accumulates():
    xs = np.random.RandomState(1).randn(T, B, D).astype("float32")
    out, _ = run_both(build_static_rnn_sum, [{"x_tm": xs}], None)
    assert_rows_equal(out)
    outs, final = out["torch"][0]
    np.testing.assert_allclose(outs, np.cumsum(xs, axis=0), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(final, outs[-1])


def build_static_rnn_train(fluid, dropout=0.0):
    main, startup = guard(fluid)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x_tm = fluid.layers.data("x", shape=[T, B, D],
                                 append_batch_size=False)
        y = fluid.layers.data("y", shape=[B, 1], dtype="int64",
                              append_batch_size=False)
        h0 = fluid.layers.fill_constant([B, H], "float32", 0.0)
        rnn = fluid.layers.StaticRNN()
        with rnn.step():
            w = rnn.step_input(x_tm)
            prev = rnn.memory(init=h0)
            h = fluid.layers.fc([w, prev], size=H, act="tanh")
            if dropout:
                h = fluid.layers.dropout(
                    h, dropout_prob=dropout,
                    dropout_implementation="upscale_in_train")
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        outs = rnn()  # [T, B, H]
        last = fluid.layers.slice(outs, axes=[0], starts=[T - 1], ends=[T])
        last = fluid.layers.squeeze(last, axes=[0])
        logits = fluid.layers.fc(last, size=3)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Adam(5e-3).minimize(loss)
    return main, startup, [loss, outs]


def rnn_feed(seed=2):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(T, B, D).astype("float32"),
            "y": rng.randint(0, 3, (B, 1)).astype("int64")}


def test_static_rnn_trains_as_the_jax_package():
    out, states = run_both(build_static_rnn_train, [rnn_feed()], None,
                           steps=5)
    assert_rows_equal(out)
    losses = [float(r[0]) for r in out["torch"]]
    assert losses[-1] < losses[0]
    for n, want in states["jax"].items():
        got = states["torch"][n]
        assert np.linalg.norm(got - want) <= 1e-5 * max(
            np.linalg.norm(want), 1.0), n


def test_static_rnn_program_is_the_jax_packages():
    jmain = build_static_rnn_train(jfluid)[0]
    tmain = build_static_rnn_train(tfluid)[0]
    assert len(tmain.blocks) == len(jmain.blocks) == 2
    for jb, tb in zip(jmain.blocks, tmain.blocks):
        assert [o.type for o in tb.ops] == [o.type for o in jb.ops]
        assert sorted(tb.vars) == sorted(jb.vars)
    rec = [o for o in tmain.global_block.ops if o.type == "recurrent"][0]
    jrec = [o for o in jmain.global_block.ops if o.type == "recurrent"][0]
    assert rec.attrs == jrec.attrs


def test_static_rnn_dropout_masks_eager_equal_captured():
    """A dropout inside the step draws a fresh mask each timestep; an
    eager run and ``CompiledProgram`` draw the same, bit for bit."""
    main, startup, (loss, outs) = build_static_rnn_train(tfluid, 0.5)
    exe = tfluid.Executor(tfluid.CPUPlace())
    init = tfluid.Scope()
    exe.run(startup, scope=init)
    arrays = {n: init.as_numpy(n) for n in init.vars}

    def run(prog):
        scope = tfluid.io.state_from_numpy(main, arrays, tfluid.Scope(),
                                           tfluid.CPUPlace())
        rows = [exe.run(prog, feed=rnn_feed(), fetch_list=[loss, outs],
                        scope=scope) for _ in range(3)]
        return rows, {n: scope.as_numpy(n) for n in arrays}

    main._tpu_step_counter = 0
    eager, eager_state = run(main)
    main._tpu_step_counter = 0
    captured, captured_state = run(tfluid.CompiledProgram(main))
    for e, c in zip(eager, captured):
        for a, b in zip(e, c):
            np.testing.assert_array_equal(a, b)
    for n in arrays:
        np.testing.assert_array_equal(eager_state[n], captured_state[n])
    dropped = eager[0][1] == 0.0  # tanh is never exactly 0
    assert 0.2 < dropped.mean() < 0.8
    assert len({m.tobytes() for m in dropped}) == T  # one mask a timestep


def build_ifelse(fluid):
    main, startup = guard(fluid)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[4])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        limit = fluid.layers.fill_constant([1], "int64", 5)
        cond_v = fluid.layers.less_than(label, limit)
        ie = fluid.layers.IfElse(cond_v)
        with ie.true_block():
            ie.output(fluid.layers.scale(ie.input(x), scale=2.0))
        with ie.false_block():
            ie.output(fluid.layers.scale(ie.input(x), scale=-1.0))
        out, = ie()
    return main, startup, [out]


def test_ifelse_row_routing():
    rng = np.random.RandomState(3)
    x_np = rng.randn(8, 4).astype("float32")
    lab_np = rng.randint(0, 10, (8, 1)).astype("int64")
    out, _ = run_both(build_ifelse, [{"x": x_np, "label": lab_np}], None)
    assert_rows_equal(out, rtol=0, atol=0)
    np.testing.assert_allclose(
        out["torch"][0][0], np.where(lab_np < 5, x_np * 2.0, x_np * -1.0),
        rtol=1e-6)


def test_ifelse_trains_through_both_branches():
    """The blend's gradient reaches each branch's rows only."""
    main, startup = guard(tfluid)
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", shape=[4])
        label = tfluid.layers.data("label", shape=[1], dtype="int64")
        h = tfluid.layers.fc(x, size=4)
        cond_v = tfluid.layers.less_than(
            label, tfluid.layers.fill_constant([1], "int64", 5))
        ie = tfluid.layers.IfElse(cond_v)
        with ie.true_block():
            ie.output(tfluid.layers.scale(ie.input(h), scale=2.0))
        with ie.false_block():
            ie.output(tfluid.layers.scale(ie.input(h), scale=0.0))
        out, = ie()
        loss = tfluid.layers.reduce_sum(out)
        tfluid.optimizer.SGD(0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    lab = np.array([[1], [7], [2], [9]], np.int64)
    x_np = np.random.RandomState(4).randn(4, 4).astype("float32")
    grad, = exe.run(main, feed={"x": x_np, "label": lab},
                    fetch_list=["fc_0.w_0@GRAD"], scope=scope)
    # d sum(2 * (x W + b)) / dW over the rows with label < 5
    want = 2 * np.repeat(x_np[(lab < 5).ravel()].sum(0)[:, None], 4, 1)
    np.testing.assert_allclose(grad, want, rtol=1e-5, atol=1e-6)


def build_switch(fluid):
    """``chip_smoke.build_switch``: 0.1 below step 10, 0.01 below 20, 0.001
    after."""
    main, startup, lr = chip_smoke.build_switch(fluid)
    return main, startup, [lr]


def test_switch_first_match_wins():
    feeds = [{"step": np.asarray([s], "float32")} for s in (5.0, 15.0, 25.0)]
    out, _ = run_both(build_switch, feeds, None, steps=3)
    assert_rows_equal(out, rtol=0, atol=0)
    got = [float(r[0][0]) for r in out["torch"]]
    np.testing.assert_allclose(got, [0.1, 0.01, 0.001], rtol=1e-6)


def test_switch_refuses_capture_by_name():
    """The captured step captures a ``conditional_block``: the Switch
    program runs as a captured step (both branches on the device, each
    output selected by the predicate), with the JAX package's
    CompiledProgram rates at steps 5, 15 and 25, no step counted eager and
    no warning."""
    main, startup, _ = build_switch(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    compiled = tfluid.CompiledProgram(main)
    got = []
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        for s in (5.0, 15.0, 25.0):
            got.append(float(exe.run(
                compiled, feed={"step": np.asarray([s], "float32")},
                fetch_list=["sw_lr"], scope=scope)[0][0]))
    np.testing.assert_allclose(got, [0.1, 0.01, 0.001], rtol=1e-6)
    assert exe.host_op_steps == 0
    assert main._tpu_step_counter == 3
    cap, = exe._captured.values()
    assert cap.host_op is None and cap.state is not None


def build_while_grad(fluid, loss_reads_carry):
    """A parameter's fc feeds a ``while`` carry summed over 3 iterations;
    the loss reads the carry or only the fc."""
    main, startup = guard(fluid)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[2, 4], append_batch_size=False)
        h = fluid.layers.fc(x, size=4)
        i = fluid.layers.fill_constant([1], "int64", 0)
        n = fluid.layers.fill_constant([1], "int64", 3)
        acc = fluid.layers.fill_constant([2, 4], "float32", 0.0)
        cond = fluid.layers.less_than(i, n)
        w = fluid.layers.While(cond)
        with w.block():
            fluid.layers.assign(fluid.layers.elementwise_add(acc, h), acc)
            fluid.layers.increment(i, in_place=True)
            fluid.layers.less_than(i, n, cond=cond)
        loss = fluid.layers.mean(acc if loss_reads_carry else h)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, [loss, acc]


def grad_feed():
    return {"x": np.random.RandomState(5).randn(2, 4).astype("float32")}


def test_while_gradient_raises_where_the_jax_package_does():
    for fluid in (jfluid, tfluid):
        main, startup, fetch = build_while_grad(fluid, True)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            with pytest.raises(ValueError, match="[Rr]everse-mode "
                                                 "differentiation"):
                exe.run(main, feed=grad_feed(), fetch_list=fetch)


def test_while_trains_where_the_loss_does_not_read_the_carry():
    out, states = run_both(lambda f: build_while_grad(f, False),
                           [grad_feed()], None, steps=3)
    assert_rows_equal(out)
    losses = [float(r[0]) for r in out["torch"]]
    assert losses[-1] < losses[0]
    for n, want in states["jax"].items():
        np.testing.assert_allclose(states["torch"][n], want, rtol=1e-5,
                                   atol=1e-6)


def build_empty_carry(fluid):
    main, startup = guard(fluid)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        i = fluid.layers.fill_constant([1], "int64", 0)
        n = fluid.layers.fill_constant([1], "int64", 3)
        x = fluid.layers.fill_constant([2], "float32", 1.0)
        arr = fluid.layers.create_array("float32")
        cond = fluid.layers.less_than(i, n)
        w = fluid.layers.While(cond)
        with w.block():
            fluid.layers.array_write(x, i, array=arr)
            fluid.layers.increment(i, in_place=True)
            fluid.layers.less_than(i, n, cond=cond)
    return main, startup, [i]


def test_while_carrying_an_unwritten_array_raises_as_the_jax_package():
    msgs = []
    for fluid in (jfluid, tfluid):
        main, startup, fetch = build_empty_carry(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            with pytest.raises(Exception) as info:
                exe.run(main, feed={}, fetch_list=fetch)
        msgs.append(str(info.value))
    for m in msgs:
        assert "was never written before it" in m and "'while'" in m


SLICE_OPS = {"while", "conditional_block", "recurrent", "create_array",
             "write_to_array", "read_from_array", "lod_array_length",
             "array_to_tensor", "beam_search", "beam_search_decode",
             "tensor_array_to_tensor"}


def test_the_slice_registers_its_ops_as_the_jax_package():
    from paddle_tpu.core.registry import registered_ops as jax_ops
    from paddle_tpu_torch.core.registry import registered_ops

    ported = set(registered_ops())
    assert SLICE_OPS <= ported and len(ported) == 294
    assert ported <= set(jax_ops())
    for name in ("While", "cond", "StaticRNN", "IfElse", "Switch",
                 "is_empty", "beam_search", "beam_search_decode",
                 "create_array", "array_write", "array_read",
                 "array_length", "array_to_tensor"):
        assert hasattr(tfluid.layers, name) and hasattr(jfluid.layers, name)
    assert tfluid.layers.beam_search_mod.__name__.endswith(
        "layers.beam_search")
    assert tfluid.contrib.decoder.beam_search is tfluid.layers.beam_search
