"""Control flow inside the port's captured step, on the CPU.

``CompiledProgram`` and ``run_steps`` capture what the JAX package
compiles as control flow. On the CPU the captured step runs its static
body (the static state, feeds and carry buffers, without a graph), so
these tests hold that logic to ``Executor.run`` and to the JAX package:

* the ``While`` sums (45 after 10 iterations) through ``run_steps`` and
  ``CompiledProgram``, equal to the JAX package's ``CompiledProgram``;
* ``chip_smoke.build_nmt_decode`` at test width through
  ``CompiledProgram``, a loop that runs to ``max_len`` and one that ends
  early: equal to ``Executor.run`` and to the JAX package (ids identical,
  scores 1e-5);
* the ``Switch`` schedule through ``run_steps``, captured;
* a ``cond`` whose branches carry gradients, one of them dividing by a
  feed that is 0 where it is not taken (a NaN in its backward), trained 4
  steps: equal to eager and to the JAX package at 1e-6;
* a dropout inside a captured ``cond`` and inside a ``while`` body: equal
  to eager bit for bit;
* ``write_carry`` over a carry whose values swap buffers;
* what stays eager, counted and warned: a branch holding ``gather``, and
  a ``while`` in a program that trains.
"""

import warnings

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.ops import control_flow_ops
from test_torch_control_flow import (build_switch, build_while_grad,
                                     build_while_sums)

PACKAGES = {"jax": jfluid, "torch": tfluid}
NMT_CFG = dict(dict_size=50, embedding_dim=8, encoder_size=8,
               decoder_size=8, batch=3, src_t=7, beam=3, max_len=6, bos=0,
               eos=1)


def start_state(fluid, main, startup):
    """The JAX startup state as arrays, or the port's when ``fluid`` is
    the port (for programs only the port builds)."""
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
    return {n: np.asarray(v) for n, v in scope.vars.items()}


def port_rows(main, start, feeds, fetch, mode, fetch_every=1):
    """Rows of the port's ``main`` over ``feeds`` from ``start`` by
    ``run`` (eager), ``compiled`` (``CompiledProgram`` a step) or
    ``run_steps``; the step counter from 0. Returns (rows, final state,
    executor)."""
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.io.state_from_numpy(main, start, tfluid.Scope(),
                                       tfluid.CPUPlace())
    main._tpu_step_counter = 0
    if mode == "run_steps":
        rows = exe.run_steps(main, feeds, steps=len(feeds), fetch_list=fetch,
                             fetch_every=fetch_every, scope=scope)
    else:
        prog = main if mode == "run" else tfluid.CompiledProgram(main)
        rows = [exe.run(prog, feed=f, fetch_list=fetch, scope=scope)
                for f in feeds]
    rows = [[np.asarray(v) for v in r] for r in rows]
    return rows, {n: scope.as_numpy(n) for n in start}, exe


def jax_rows(build, feeds, compiled=True):
    """(rows, startup state) of the JAX package's program."""
    main, startup, fetch = build(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        start = {n: np.asarray(v) for n, v in scope.vars.items()}
        prog = jfluid.CompiledProgram(main) if compiled else main
        rows = [[np.asarray(v) for v in exe.run(prog, feed=f,
                                                fetch_list=fetch)]
                for f in feeds]
    return rows, start


def assert_bits(a_rows, b_rows):
    assert len(a_rows) == len(b_rows)
    for a, b in zip(a_rows, b_rows):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def captured_cleanly(exe):
    """Every captured step of ``exe`` left its static buffers and none ran
    eagerly."""
    assert exe.host_op_steps == 0
    assert all(c.host_op is None and c.state is not None
               for c in exe._captured.values())


@pytest.mark.parametrize("mode", ("compiled", "run_steps"))
def test_while_sums_are_captured(mode):
    feeds = [{}] * 4
    want, start = jax_rows(build_while_sums, feeds)
    main, _, fetch = build_while_sums(tfluid)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got, _, exe = port_rows(main, start, feeds, fetch, mode,
                                fetch_every=2)
    captured_cleanly(exe)
    cap, = exe._captured.values()
    assert [p[2] is not None for p in cap.pieces] == [True, False]
    for row in got:
        assert float(row[0][0]) == 45.0 and int(row[1][0]) == 10
    assert_bits(got, want)


def nmt_build(cfg):
    def build(fluid):
        main, startup, sent_ids, sent_scores, steps = \
            chip_smoke.build_nmt_decode(fluid, cfg)
        return main, startup, [sent_ids, sent_scores, steps]

    return build


@pytest.mark.parametrize("early_end", (False, True))
def test_nmt_beam_decode_is_captured(early_end):
    """Three batches through ``CompiledProgram`` (two warm-ups, then the
    static body): the ids and scores of ``Executor.run`` bit for bit and
    of the JAX package (ids identical, scores 1e-5). With the output bias
    of ``eos`` at +50 the loop ends after 2 of its 9 steps."""
    cfg = dict(NMT_CFG, max_len=9) if early_end else NMT_CFG
    build = nmt_build(cfg)
    feeds = [chip_smoke.nmt_decode_feed(cfg, seed) for seed in (0, 1, 0)]
    main, startup, fetch = build(tfluid)
    start = start_state(tfluid, main, startup)
    if early_end:
        start["dec_out_b"] = start["dec_out_b"].copy()
        start["dec_out_b"].reshape(-1)[cfg["eos"]] = 50.0
    eager, _, _ = port_rows(main, start, feeds, fetch, "run")
    got, _, exe = port_rows(main, start, feeds, fetch, "compiled")
    captured_cleanly(exe)
    assert_bits(got, eager)
    jmain, _, jfetch = build(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    for n, v in start.items():
        jscope.set_var(n, v)
    with jfluid.scope_guard(jscope):
        want = [[np.asarray(v) for v in jexe.run(
            jfluid.CompiledProgram(jmain), feed=f, fetch_list=jfetch)]
            for f in feeds]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_allclose(g[1], w[1], rtol=1e-5, atol=1e-5)
        assert int(g[2][0]) == int(w[2][0]) == (2 if early_end else 6)


def test_switch_schedule_is_captured():
    steps = (5.0, 15.0, 25.0, 12.0, 3.0)
    feeds = [{"step": np.asarray([s], "float32")} for s in steps]
    want, start = jax_rows(build_switch, feeds)
    main, _, fetch = build_switch(tfluid)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got, _, exe = port_rows(main, start, feeds, fetch, "run_steps",
                                fetch_every=5)
    captured_cleanly(exe)
    rates = [float(r[0][0]) for r in got]
    np.testing.assert_allclose(rates, [0.1, 0.01, 0.001, 0.01, 0.1],
                               rtol=1e-6)
    assert_bits(got, want)


def build_cond_train(fluid):
    """An fc whose output either divides by the feed ``den`` or doubles,
    chosen by the feed ``flag``; the loss squares the chosen branch. A
    ``den`` of 0 goes with ``flag`` False: the division, not taken, gives
    inf forward and NaN backward."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        x = L.data("x", shape=[4, 3], append_batch_size=False)
        den = L.data("den", shape=[4, 4], append_batch_size=False)
        flag = L.data("flag", shape=[1], dtype="bool",
                      append_batch_size=False)
        h = L.fc(x, size=4)
        out = L.cond(flag, lambda: L.elementwise_div(h, den),
                     lambda: L.scale(h, scale=2.0))
        loss = L.mean(L.square(out))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, [loss]


def cond_feeds():
    rng = np.random.RandomState(5)
    out = []
    for taken, d in ((True, 2.0), (False, 0.0), (True, 4.0), (False, 0.0)):
        out.append({"x": rng.randn(4, 3).astype("float32"),
                    "den": np.full((4, 4), d, "float32"),
                    "flag": np.asarray([taken])})
    return out


def test_cond_gradients_reach_only_the_taken_branch():
    feeds = cond_feeds()
    want, start = jax_rows(build_cond_train, feeds, compiled=False)
    main, _, fetch = build_cond_train(tfluid)
    eager, eager_end, _ = port_rows(main, start, feeds, fetch, "run")
    got, got_end, exe = port_rows(main, start, feeds, fetch, "compiled")
    captured_cleanly(exe)
    for rows in (eager, got):
        assert all(np.isfinite(r[0]).all() for r in rows)
        for g, w in zip(rows, want):
            np.testing.assert_allclose(g[0], w[0], rtol=1e-6, atol=1e-6)
    for n in start:
        np.testing.assert_allclose(got_end[n], eager_end[n], rtol=1e-6,
                                   atol=1e-6)
        assert np.isfinite(got_end[n]).all()


def build_dropout_cond(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        x = L.data("x", shape=[8, 16], append_batch_size=False)
        flag = L.data("flag", shape=[1], dtype="bool",
                      append_batch_size=False)
        out = L.cond(flag, lambda: L.dropout(x, 0.5),
                     lambda: L.dropout(L.scale(x, scale=2.0), 0.5))
    return main, startup, [out]


def build_dropout_while(fluid):
    """Three iterations of ``acc += dropout(x)``."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 13
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        x = L.data("x", shape=[8, 16], append_batch_size=False)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        acc = L.fill_constant([8, 16], "float32", 0.0)
        cond = L.less_than(i, n)
        loop = L.While(cond)
        with loop.block():
            L.assign(L.elementwise_add(acc, L.dropout(x, 0.5)), acc)
            L.increment(i, in_place=True)
            L.less_than(i, n, cond=cond)
    return main, startup, [acc]


@pytest.mark.parametrize("build", (build_dropout_cond, build_dropout_while))
def test_dropout_draws_what_it_draws_eagerly(build):
    rng = np.random.RandomState(2)
    feeds = [{"x": rng.rand(8, 16).astype("float32") + 0.5,
              "flag": np.asarray([k % 2 == 0])} for k in range(5)]
    main, startup, fetch = build(tfluid)
    if build is build_dropout_while:
        feeds = [{"x": f["x"]} for f in feeds]
    eager, _, _ = port_rows(main, {}, feeds, fetch, "run")
    got, _, exe = port_rows(main, {}, feeds, fetch, "compiled")
    captured_cleanly(exe)
    assert_bits(got, eager)
    dropped = np.stack([r[0] for r in eager]) == 0.0
    assert 0.05 < dropped.mean() < 0.95
    assert len({d.tobytes() for d in dropped}) == len(feeds)


def test_write_carry_swaps_without_reading_a_written_buffer():
    a, b = torch.arange(4.0), torch.arange(4.0) + 10
    arr = (torch.zeros(3, 4), torch.tensor(1, dtype=torch.int32))
    env = {"a": a, "b": b, "arr": arr}
    new_arr = (arr[0], torch.tensor(2, dtype=torch.int32))
    new_arr[0][1] = 5.0  # an in-place write stays where it is
    local = {"a": b, "b": a[:], "arr": new_arr}
    control_flow_ops.write_carry(env, local, ["a", "b", "arr"])
    assert env["a"] is a and env["b"] is b and env["arr"] is arr
    np.testing.assert_array_equal(a.numpy(), np.arange(4.0) + 10)
    np.testing.assert_array_equal(b.numpy(), np.arange(4.0))
    assert int(arr[1]) == 2 and float(arr[0][1, 0]) == 5.0


def build_gather_branch(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        x = L.data("x", shape=[4, 3], append_batch_size=False)
        idx = L.data("idx", shape=[2], dtype="int64",
                     append_batch_size=False)
        flag = L.data("flag", shape=[1], dtype="bool",
                      append_batch_size=False)
        out = L.cond(flag, lambda: L.gather(x, idx),
                     lambda: L.slice(x, axes=[0], starts=[0], ends=[2]))
    return main, startup, [out]


@pytest.mark.parametrize("case", ("gather_branch", "while_trains"))
def test_what_stays_eager_is_counted_and_named(case):
    if case == "gather_branch":
        main, startup, fetch = build_gather_branch(tfluid)
        x = np.arange(12, dtype="float32").reshape(4, 3)
        feeds = [{"x": x, "idx": np.asarray([3, 1]),
                  "flag": np.asarray([True])},
                 {"x": x, "idx": np.asarray([9, 9]),
                  "flag": np.asarray([False])}]
        op = "conditional_block"
    else:
        main, startup, fetch = build_while_grad(tfluid, False)
        feeds = [{"x": np.ones((2, 4), "float32")}] * 2
        op = "while"
    start = start_state(tfluid, main, startup)
    eager, _, _ = port_rows(main, start, feeds, fetch, "run")
    with pytest.warns(RuntimeWarning, match=r"'%s' \(block 0, index" % op):
        got, _, exe = port_rows(main, start, feeds, fetch, "compiled")
    assert exe.host_op_steps == len(feeds)
    assert_bits(got, eager)
    if case == "gather_branch":
        np.testing.assert_array_equal(got[0][0], x[[3, 1]])
