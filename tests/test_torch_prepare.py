"""``Executor.prepare`` and ``Executor.memory_report`` on the CPU.

* ``prepare`` warms the captured step up on copies: the scope's tensors,
  their values and the program's step counter stay as they were;
* ``prepare`` and then N steps give the bits of N steps (dropout on, so
  every step's generators are reseeded alike), through ``CompiledProgram``
  and through ``run_steps``, and a prepared ``While`` decode too;
* ``memory_report`` on the CPU gives the keys the CPU can measure
  (``argument_bytes``, ``output_bytes``, ``alias_bytes``), a subset of
  the JAX package's, with the bytes of the static state and feeds;
* abstract ``(shape, dtype)`` feeds prepare the step a later run with
  arrays of those shapes takes, in both packages.
"""

import numpy as np
import pytest

import chip_smoke
import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

BATCH = 8


def build(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 17
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        x = L.data("x", shape=[16])
        y = L.data("y", shape=[1], dtype="int64")
        h = L.dropout(L.fc(x, size=32, act="relu"), 0.3)
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, size=4), y))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


def feed(i):
    rng = np.random.RandomState(i)
    return {"x": rng.randn(BATCH, 16).astype("float32"),
            "y": rng.randint(0, 4, (BATCH, 1)).astype("int64")}


def fresh():
    main, startup, loss = build(tfluid)
    init = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=init)
    return main, loss, {n: init.as_numpy(n) for n in init.vars}


def scope_of(main, arrays):
    return tfluid.io.state_from_numpy(main, arrays, tfluid.Scope(),
                                      tfluid.CPUPlace())


def test_prepare_leaves_the_scope_and_the_step_counter():
    main, loss, arrays = fresh()
    scope = scope_of(main, arrays)
    tensors = dict(scope.vars)
    exe = tfluid.Executor(tfluid.CPUPlace())
    cap = exe.prepare(tfluid.CompiledProgram(main), feed(0), [loss], scope)
    assert getattr(main, "_tpu_step_counter", 0) == 0
    assert cap.warm_left == 0 and cap.state is not None
    for n, t in tensors.items():
        assert scope.find_var(n) is t
        np.testing.assert_array_equal(scope.as_numpy(n), arrays[n])


@pytest.mark.parametrize("mode", ("compiled", "run_steps"))
def test_prepare_then_n_steps_equal_n_steps(mode):
    main, loss, arrays = fresh()
    feeds = [feed(i) for i in range(4)]
    got = {}
    for prepared in (False, True):
        scope = scope_of(main, arrays)
        exe = tfluid.Executor(tfluid.CPUPlace())
        main._tpu_step_counter = 0
        if prepared:
            exe.prepare(main, feeds[0], [loss], scope)
        if mode == "compiled":
            rows = [exe.run(tfluid.CompiledProgram(main), feed=f,
                            fetch_list=[loss], scope=scope) for f in feeds]
        else:
            rows = exe.run_steps(main, feeds, steps=4, fetch_list=[loss],
                                 fetch_every=2, scope=scope)
        got[prepared] = ([float(np.asarray(r[0]).reshape(-1)[0])
                          for r in rows],
                         {n: scope.as_numpy(n) for n in arrays},
                         main._tpu_step_counter)
        cap, = exe._captured.values()
        assert cap.state is not None
    (plain, plain_state, plain_steps), (prep, prep_state, prep_steps) = \
        got[False], got[True]
    assert prep == plain and prep_steps == plain_steps == 4
    for n in arrays:
        np.testing.assert_array_equal(prep_state[n], plain_state[n])


def test_a_prepared_while_decode_equals_its_runs():
    cfg = dict(dict_size=50, embedding_dim=8, encoder_size=8,
               decoder_size=8, batch=3, src_t=7, beam=3, max_len=6, bos=0,
               eos=1)
    main, startup, ids, scores, steps = chip_smoke.build_nmt_decode(tfluid,
                                                                    cfg)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    fetch = [ids, scores, steps]
    f = chip_smoke.nmt_decode_feed(cfg)
    want = [np.asarray(v) for v in exe.run(main, feed=f, fetch_list=fetch,
                                           scope=scope)]
    abstract = {n: (v.shape, v.dtype) for n, v in f.items()}
    exe.prepare(tfluid.CompiledProgram(main), abstract, fetch, scope)
    got = exe.run(tfluid.CompiledProgram(main), feed=f, fetch_list=fetch,
                  scope=scope)
    cap, = exe._captured.values()
    assert cap.pieces is not None and exe.host_op_steps == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_memory_report_keys_on_the_cpu():
    main, loss, arrays = fresh()
    scope = scope_of(main, arrays)
    exe = tfluid.Executor(tfluid.CPUPlace())
    rep = exe.memory_report(main, {"x": ((BATCH, 16), "float32"),
                                   "y": ((BATCH, 1), "int64")},
                            [loss], scope)
    assert set(rep) == {"argument_bytes", "output_bytes", "alias_bytes"}
    state = sum(a.nbytes for a in arrays.values())
    assert rep["argument_bytes"] == state + BATCH * 16 * 4 + BATCH * 8
    # every parameter and Adam accumulator is written in place, and the
    # loss is one more float
    assert rep["alias_bytes"] <= rep["output_bytes"] == rep["alias_bytes"] + 4
    jmain, jstartup, jloss = build(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        jrep = jexe.memory_report(jmain, {"x": ((BATCH, 16), "float32"),
                                          "y": ((BATCH, 1), "int64")},
                                  [jloss])
    # the JAX package's CPU backend also reports its buffers' temporaries
    assert set(rep) < set(jrep)
    # int64 labels in the port, int32 in the JAX package (x64 off)
    assert rep["argument_bytes"] - jrep["argument_bytes"] == BATCH * 4


def test_abstract_feeds_prepare_the_step_a_later_run_takes():
    main, loss, arrays = fresh()
    scope = scope_of(main, arrays)
    exe = tfluid.Executor(tfluid.CPUPlace())
    abstract = {"x": ((BATCH, 16), np.float32), "y": ([BATCH, 1], "int64")}
    cap = exe.prepare(main, abstract, [loss], scope)
    rows = exe.run_steps(main, [feed(i) for i in range(3)], steps=3,
                         fetch_list=[loss], scope=scope)
    assert list(exe._captured.values()) == [cap]
    plain_scope = scope_of(main, arrays)
    main._tpu_step_counter = 0
    plain = tfluid.Executor(tfluid.CPUPlace())
    want = [plain.run(main, feed=feed(i), fetch_list=[loss],
                      scope=plain_scope) for i in range(3)]
    for r, w in zip(rows, want):
        np.testing.assert_array_equal(r[0], w[0])
    # the JAX package's prepare takes the same call
    jmain, jstartup, jloss = build(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        jexe.run(jstartup)
        jexe.prepare(jmain, abstract, [jloss])
