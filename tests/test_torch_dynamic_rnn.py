"""The port's DynamicRNN matches the JAX package's.

One program built by both packages (equal op for op, the sub-block
included): a step input with a ``Length`` (rows of length 6, 1, 3 and 5
in a padded T of 6), a static input seen whole at every step, a memory
from ``init=`` and one from ``shape=``/``value=`` (the
``fill_constant_batch_size_like`` the layer appends), and an ``fc``
inside the block whose weights are trainable parameters of the global
block. From the JAX startup state carried by ``io.state_from_numpy``,
three ``SGD`` steps on the CPU: losses, both outputs, the final states
and the fc's gradients and trained weights to 1e-5.

Also held: the layer's ``ValueError`` messages equal the JAX layer's; a
dropout inside the block draws a fresh mask every timestep from its one
generator, and the masks are the same eager and through
``CompiledProgram``; an error inside the block is raised once, naming the
inner op.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

B, T, D, S, H = 4, 6, 3, 2, 5
LENGTHS = np.array([6, 1, 3, 5], np.int64)


def build(fluid, dropout=0.0, steps_lr=0.1):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[T, D])
        length = fluid.layers.data("length", shape=[], dtype="int64")
        s = fluid.layers.data("s", shape=[S])
        h0 = fluid.layers.data("h0", shape=[H])
        drnn = fluid.layers.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x, length=length)
            st = drnn.static_input(s)
            prev = drnn.memory(init=h0)
            acc = drnn.memory(shape=[H], value=0.5)
            h = fluid.layers.fc([x_t, prev, st], size=H, act="tanh")
            if dropout:
                h = fluid.layers.dropout(
                    h, dropout_prob=dropout,
                    dropout_implementation="upscale_in_train")
            acc_new = fluid.layers.elementwise_add(
                acc, fluid.layers.scale(h, scale=0.5))
            drnn.update_memory(prev, h)
            drnn.update_memory(acc, acc_new)
            drnn.output(h, acc_new)
        out, out_acc = drnn()
        finals = drnn.final_states
        loss = fluid.layers.elementwise_add(
            fluid.layers.mean(out), fluid.layers.mean(
                fluid.layers.elementwise_mul(out_acc, out_acc)))
        fluid.optimizer.SGD(steps_lr).minimize(loss)
    return main, startup, loss, [out, out_acc] + list(finals)


def feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(B, T, D).astype(np.float32),
            "length": LENGTHS,
            "s": rng.randn(B, S).astype(np.float32),
            "h0": rng.randn(B, H).astype(np.float32)}


# the fc inside the block: a weight for each of its three inputs, a bias
PARAMS = ["fc_0.b_0", "fc_0.w_0", "fc_0.w_1", "fc_0.w_2"]
GRADS = [p + "@GRAD" for p in PARAMS]


@pytest.fixture(scope="module")
def jax_run():
    main, startup, loss, outs = build(jfluid)
    scope = jfluid.Scope()
    rows = []
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        start = {n: np.asarray(v) for n, v in scope.vars.items()}
        for _ in range(3):
            rows.append([np.asarray(v) for v in exe.run(
                main, feed=feed(), fetch_list=[loss] + outs + GRADS)])
        end = {n: np.asarray(v) for n, v in scope.vars.items()}
    return main, start, rows, end


def test_program_is_the_jax_packages(jax_run):
    jmain = jax_run[0]
    tmain = build(tfluid)[0]
    assert len(tmain.blocks) == len(jmain.blocks) == 2
    for jb, tb in zip(jmain.blocks, tmain.blocks):
        assert [o.type for o in tb.ops] == [o.type for o in jb.ops]
    assert sorted(p.name for p in tmain.all_parameters()) == \
        sorted(p.name for p in jmain.all_parameters()) == PARAMS


def test_dynamic_rnn_trains_as_the_jax_package(jax_run):
    _, start, want_rows, want_end = jax_run
    main, _, loss, outs = build(tfluid)
    scope = tfluid.io.state_from_numpy(main, start, tfluid.Scope(),
                                       tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    for want in want_rows:
        got = exe.run(main, feed=feed(), fetch_list=[loss] + outs + GRADS,
                      scope=scope)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), w, rtol=1e-5,
                                       atol=1e-5)
    for n in PARAMS:
        assert not np.allclose(want_end[n], start[n])  # the fc trained
        np.testing.assert_allclose(scope.as_numpy(n), want_end[n],
                                   rtol=1e-5, atol=1e-6)


def test_padding_rows_keep_their_memories(jax_run):
    _, start, _, _ = jax_run
    main, _, _, outs = build(tfluid)
    scope = tfluid.io.state_from_numpy(main, start, tfluid.Scope(),
                                       tfluid.CPUPlace())
    f = feed()
    out, acc, final_h, final_acc = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=f, fetch_list=outs, scope=scope)
    for b, n in enumerate(LENGTHS):
        assert not out[b, n:].any() and not acc[b, n:].any()
        np.testing.assert_array_equal(final_h[b], out[b, n - 1])
        np.testing.assert_array_equal(final_acc[b], acc[b, n - 1])


def layer_error(fluid, case):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[T, D])
        flat = fluid.layers.data("flat", shape=[D], append_batch_size=False)
        drnn = fluid.layers.DynamicRNN()
        try:
            if case == "memory_outside_block":
                drnn.memory(shape=[H])
            with drnn.block():
                if case == "step_input_rank":
                    drnn.step_input(flat)
                x_t = drnn.step_input(x) if case != "no_step_input" \
                    else None
                if case == "memory_without_shape":
                    drnn.memory()
                prev = drnn.memory(shape=[D])
                if case == "update_unknown":
                    drnn.update_memory(x_t, x_t)
                if case != "never_updated":
                    drnn.update_memory(prev, prev)
                drnn.output(prev)
        except ValueError as e:
            return str(e)
    return None


ERRORS = ("step_input_rank", "memory_outside_block", "memory_without_shape",
          "update_unknown", "never_updated", "no_step_input")


@pytest.mark.parametrize("case", ERRORS)
def test_layer_errors_are_the_jax_layers(case):
    want = layer_error(jfluid, case)
    assert want is not None
    got = layer_error(tfluid, case)
    # var names come from the name generator, equal in both packages
    assert got == want


def test_dropout_inside_the_block_draws_a_fresh_mask_each_timestep():
    main, startup, loss, outs = build(tfluid, dropout=0.5, steps_lr=0.0)
    exe = tfluid.Executor(tfluid.CPUPlace())
    init = tfluid.Scope()
    exe.run(startup, scope=init)
    arrays = {n: init.as_numpy(n) for n in init.vars}
    f = feed()

    def run(prog):
        scope = tfluid.io.state_from_numpy(main, arrays, tfluid.Scope(),
                                           tfluid.CPUPlace())
        return [exe.run(prog, feed=f, fetch_list=[outs[0]], scope=scope)[0]
                for _ in range(3)]

    eager = run(main)
    main._tpu_step_counter = 0
    compiled = run(tfluid.CompiledProgram(main))
    for e, c in zip(eager, compiled):
        np.testing.assert_array_equal(e, c)
    # rows 0 and 3 run the first 5 timesteps (tanh is never exactly 0)
    dropped = (eager[0][[0, 3], :5] == 0.0).transpose(1, 0, 2)
    assert 0.2 < dropped.mean() < 0.8
    assert len({m.tobytes() for m in dropped}) == 5   # one mask a timestep
    assert not np.array_equal(eager[0] == 0.0, eager[1] == 0.0)  # and a step


def test_an_error_inside_the_block_is_raised_once_naming_the_op():
    main, startup, loss, outs = build(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    bad = feed()
    bad["s"] = np.zeros((B, S + 1), np.float32)  # its fc weight is [S, H]
    with pytest.raises(Exception) as info:
        exe.run(main, feed=bad, fetch_list=[loss], scope=scope)
    msg = str(info.value)
    assert type(info.value).__name__ == "EnforceNotMet"
    assert msg.count("Operator ") == 1 and "Operator 'mul'" in msg
    assert "index 1000" in msg  # offset 10_000 * block 1 + its position
