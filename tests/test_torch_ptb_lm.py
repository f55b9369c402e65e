"""The PTB LSTM language model through StaticRNN matches the JAX package.

``chip_smoke.build_ptb_lm`` is PaddleNLP's ``lm_model(rnn_model="static")``
program (the smoke's ``ptb_lm_train`` leg trains it at the medium
configuration): here at hidden 16, 2 layers, 5 steps, vocabulary 50 and
batch 4, built by both packages, op for op. From the JAX startup state
carried by ``io.state_from_numpy``, 5 steps of GradientClipByGlobalNorm(5)
+ SGD(1.0) at dropout 0, the last hidden and cell states fed into the
next step: losses and fetched states to 1e-5, the trained state 1e-5
norm-wise. With dropout 0.5, the port's eager steps and its captured
steps (``CompiledProgram``) are bit-equal on the CPU. A ``While``
program given to ``CompiledProgram`` runs eagerly, each step counted.
"""

import warnings

import numpy as np
import pytest

import chip_smoke
import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

CFG = dict(hidden_size=16, vocab_size=50, num_layers=2, num_steps=5,
           init_scale=0.1, dropout=0.0, batch_size=4)
STEPS = 5


def train(fluid, cfg, start=None, steps=STEPS, compiled=False):
    """``steps`` training steps, each fed the previous step's last states;
    returns (rows of [loss, last_hidden, last_cell], start state, end
    state)."""
    main, startup, loss, last_h, last_c = chip_smoke.build_ptb_lm(fluid,
                                                                  **cfg)
    exe = fluid.Executor(fluid.CPUPlace())
    if start is None:
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
        start = {n: np.asarray(v) for n, v in scope.vars.items()}
    else:
        scope = fluid.io.state_from_numpy(main, start, fluid.Scope(),
                                          fluid.CPUPlace())
    prog = tfluid.CompiledProgram(main) if compiled else main
    feed = chip_smoke.ptb_feed(cfg)
    rows = []
    with fluid.scope_guard(scope):
        for _ in range(steps):
            row = [np.asarray(v) for v in exe.run(
                prog, feed=feed, fetch_list=[loss, last_h, last_c])]
            rows.append(row)
            feed = dict(feed, init_hidden=row[1], init_cell=row[2])
    end = {n: np.asarray(scope.find_var(n)) for n in start}
    return rows, start, end


@pytest.fixture(scope="module")
def jax_run():
    return train(jfluid, CFG)


def test_program_is_the_jax_packages():
    jmain = chip_smoke.build_ptb_lm(jfluid, **CFG)[0]
    tmain = chip_smoke.build_ptb_lm(tfluid, **CFG)[0]
    assert len(tmain.blocks) == len(jmain.blocks) == 2
    for jb, tb in zip(jmain.blocks, tmain.blocks):
        assert [o.type for o in tb.ops] == [o.type for o in jb.ops]
    assert sorted(p.name for p in tmain.all_parameters()) == sorted(
        p.name for p in jmain.all_parameters())
    assert "recurrent" in [o.type for o in tmain.global_block.ops]


def test_ptb_lm_trains_as_the_jax_package(jax_run):
    want, start, want_end = jax_run
    got, _, end = train(tfluid, CFG, start=start)
    for g_row, w_row in zip(got, want):
        for g, w in zip(g_row, w_row):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    losses = [float(r[0]) for r in got]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for n, w in want_end.items():
        assert np.linalg.norm(end[n] - w) <= 1e-5 * max(np.linalg.norm(w),
                                                        1.0), n
    assert not np.allclose(end["softmax_weight"], start["softmax_weight"])


def test_eager_and_captured_steps_are_bit_equal_with_dropout(jax_run):
    cfg = dict(CFG, dropout=0.5)
    start = jax_run[1]
    eager, _, eager_end = train(tfluid, cfg, start=start, steps=3)
    captured, _, captured_end = train(tfluid, cfg, start=start, steps=3,
                                      compiled=True)
    for e_row, c_row in zip(eager, captured):
        for e, c in zip(e_row, c_row):
            np.testing.assert_array_equal(e, c)
    for n in start:
        np.testing.assert_array_equal(eager_end[n], captured_end[n])
    # dropout on: the losses differ from the dropout-0 run's
    assert float(eager[0][0]) != float(jax_run[0][0][0])


def test_compiled_program_refuses_a_while_by_name():
    """A ``While`` program given to ``CompiledProgram`` or ``run_steps`` is
    captured: its loop body is a graph of its own, replayed once an
    iteration, and each step gives what ``Executor.run`` gives (the sum 45
    after 10 iterations), with no step counted eager and no warning."""
    from test_torch_control_flow import build_while_sums

    main, startup, fetch = build_while_sums(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        for _ in range(3):  # two warm-ups, then the static body
            s, i = exe.run(tfluid.CompiledProgram(main), feed={},
                           fetch_list=fetch, scope=scope)
            assert float(s[0]) == 45.0 and int(i[0]) == 10
        (s, i), = exe.run_steps(main, [{}], steps=1, fetch_list=fetch,
                                scope=scope)
    assert float(s[0]) == 45.0 and int(i[0]) == 10
    assert exe.host_op_steps == 0 and main._tpu_step_counter == 4
    cap, = exe._captured.values()
    assert cap.host_op is None and cap.pieces is not None
    s, i = exe.run(main, feed={}, fetch_list=fetch, scope=scope)
    assert float(s[0]) == 45.0 and int(i[0]) == 10
