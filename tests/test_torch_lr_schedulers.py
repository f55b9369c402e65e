"""The port's learning-rate schedules match the JAX package's, and its step
counter advances once a step, as Fluid's does.

Each of the eight schedules of ``layers.learning_rate_scheduler``, used
alone as an MLP's SGD rate, gives the JAX package's rate at each of 12
steps to 1e-6 relative, and the same losses (1e-5). The nested
``linear_lr_warmup(polynomial_decay(1.0, 10, 0.0), 4, 0.0, 1.0)`` reads
one step a run in the port, so it gives Fluid's closed form (the counter
0, 1, 2, ...; the rate s/4 while s < 4, then 1 - min(s, 10)/10). The JAX
package appends an ``increment`` on every schedule that reads the
counter, so there the counter reads 1, 3, 5, ... and the rate 0.25, 0.75,
0.6, ...: a test pins that reference-side count.

The counter advances once a global step under
``gradient_accumulation_steps = 4`` in both packages; ``run_steps`` (the
captured step's body, step by step on the CPU) gives ``run()``'s rates,
counter and losses bit for bit; and the pass pipeline at level 1 keeps
the ``increment`` and gives level 0's rates.
"""

import math

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

COUNTER = "@LR_DECAY_COUNTER@"
STEPS = 12

SCHEDULES = {
    "noam_decay": lambda L: L.noam_decay(64, 4, learning_rate=2.0),
    "exponential_decay": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential_decay_staircase": lambda L: L.exponential_decay(
        0.1, 3, 0.5, staircase=True),
    "natural_exp_decay": lambda L: L.natural_exp_decay(0.1, 3, 0.5),
    "natural_exp_decay_staircase": lambda L: L.natural_exp_decay(
        0.1, 3, 0.5, staircase=True),
    "inverse_time_decay": lambda L: L.inverse_time_decay(0.1, 3, 0.5),
    "inverse_time_decay_staircase": lambda L: L.inverse_time_decay(
        0.1, 3, 0.5, staircase=True),
    "polynomial_decay": lambda L: L.polynomial_decay(0.1, 8, 0.01,
                                                     power=2.0),
    "piecewise_decay": lambda L: L.piecewise_decay([3, 7],
                                                   [0.1, 0.05, 0.01]),
    "cosine_decay": lambda L: L.cosine_decay(0.1, 2, 6),
    "linear_lr_warmup": lambda L: L.linear_lr_warmup(0.1, 5, 0.01, 0.1),
}


def nested(L):
    return L.linear_lr_warmup(L.polynomial_decay(1.0, 10, 0.0), 4, 0.0, 1.0)


def build(fluid, schedule, opt="sgd"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[8])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 16, act="relu")
        logits = fluid.layers.fc(h, 4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        lr = schedule(fluid.layers)
        if opt == "sgd":
            fluid.optimizer.SGD(lr).minimize(loss)
        else:
            fluid.optimizer.Adam(lr).minimize(loss)
    return main, startup, loss, lr


def feed(i, batch=8):
    rng = np.random.RandomState(i)
    return {"x": rng.randn(batch, 8).astype("float32"),
            "y": rng.randint(0, 4, (batch, 1)).astype("int64")}


def jax_run(schedule, steps=STEPS, accum=None, opt="sgd"):
    """(losses, rates, counters) of the JAX package, and its startup
    arrays."""
    main, startup, loss, lr = build(jfluid, schedule, opt)
    prog = main
    if accum:
        bs = jfluid.BuildStrategy()
        bs.gradient_accumulation_steps = accum
        prog = jfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs,
            places=[jfluid.CPUPlace()])
    scope = jfluid.Scope()
    out = []
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        arrays = {n: np.asarray(v) for n, v in scope.vars.items()}
        for i in range(steps):
            lv, rv, cv = exe.run(prog, feed=feed(i),
                                 fetch_list=[loss, lr, COUNTER])
            out.append((float(np.ravel(lv)[0]), float(np.ravel(rv)[0]),
                        int(np.ravel(cv)[0])))
    return [list(c) for c in zip(*out)], arrays


def port_run(schedule, arrays=None, steps=STEPS, accum=None, opt="sgd"):
    main, startup, loss, lr = build(tfluid, schedule, opt)
    prog = main
    if accum:
        bs = tfluid.BuildStrategy()
        bs.gradient_accumulation_steps = accum
        prog = tfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs)
    exe = tfluid.Executor(tfluid.CPUPlace())
    if arrays is None:
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
    else:
        scope = tfluid.io.state_from_numpy(main, arrays, tfluid.Scope(),
                                           tfluid.CPUPlace())
    out = []
    for i in range(steps):
        lv, rv, cv = exe.run(prog, feed=feed(i),
                             fetch_list=[loss, lr, COUNTER], scope=scope)
        out.append((float(np.ravel(lv)[0]), float(np.ravel(rv)[0]),
                    int(np.ravel(cv)[0])))
    return [list(c) for c in zip(*out)], main, scope


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_alone_matches_jax(name):
    (jl, jr, jc), arrays = jax_run(SCHEDULES[name])
    (tl, tr, tc), main, _ = port_run(SCHEDULES[name], arrays)
    assert [op.type for op in main.global_block.ops].count("increment") == 1
    np.testing.assert_allclose(tr, jr, rtol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tc == jc
    begin = 1 if name == "noam_decay" else 0
    assert tc == list(range(begin, begin + STEPS))
    assert len(set(tr)) > 1


def fluid_nested(step):
    """Fluid's rate of the nested schedule at step ``step`` (one increment
    a step, the counter from 0)."""
    if step < 4:
        return step / 4.0
    return 1.0 - min(step, 10) / 10.0


def test_nested_schedule_gives_fluids_closed_form():
    (_, rates, counters), main, _ = port_run(nested)
    ops = [op.type for op in main.global_block.ops]
    assert ops.count("increment") == 1
    assert counters == list(range(STEPS))
    want = [fluid_nested(s) for s in counters]
    np.testing.assert_allclose(rates, want, rtol=1e-6, atol=1e-7)


def test_jax_package_counts_twice_with_two_schedules():
    """Reference-side: the JAX package's ``autoincreased_step_counter``
    appends an ``increment`` on every call, so the nested schedule
    advances the counter twice a step and warms up over half the steps."""
    main, _, _, _ = build(jfluid, nested)
    assert [op.type for op in main.global_block.ops].count("increment") == 2
    (_, rates, counters), _ = jax_run(nested, steps=6)
    assert counters == [1, 3, 5, 7, 9, 11]
    np.testing.assert_allclose(rates, [0.25, 0.75, 0.6, 0.4, 0.2, 0.0],
                               rtol=1e-6, atol=1e-6)


def test_two_schedules_on_one_counter_read_one_step():
    def two(L):
        a = L.noam_decay(64, 4)
        return L.elementwise_add(a, L.noam_decay(64, 4))

    (_, rates, counters), main, _ = port_run(two, steps=4)
    assert counters == [1, 2, 3, 4]
    want = [2 * 64 ** -0.5 * min(s ** -0.5, s * 4 ** -1.5)
            for s in counters]
    np.testing.assert_allclose(rates, want, rtol=1e-6)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_counter_advances_once_a_step_under_accumulation(opt):
    """4 microbatches run the forward (and the increment) 4 times from the
    step's state: the counter advances once a global step in both
    packages, and the rates and losses agree."""
    (jl, jr, jc), arrays = jax_run(nested, steps=6, accum=4, opt=opt)
    (tl, tr, tc), _, _ = port_run(nested, arrays, steps=6, accum=4, opt=opt)
    assert jc == [1, 3, 5, 7, 9, 11]  # the JAX package's two increments
    assert tc == list(range(6))
    np.testing.assert_allclose(tr, [fluid_nested(s) for s in tc], rtol=1e-6,
                               atol=1e-7)
    # one schedule alone: the same counts and rates in both packages
    (jl, jr, jc), arrays = jax_run(SCHEDULES["noam_decay"], steps=6,
                                   accum=4, opt=opt)
    (tl, tr, tc), _, _ = port_run(SCHEDULES["noam_decay"], arrays, steps=6,
                                  accum=4, opt=opt)
    assert tc == jc == list(range(1, 7))
    np.testing.assert_allclose(tr, jr, rtol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


@pytest.mark.parametrize("name", ["nested", "piecewise_decay"])
def test_run_steps_equals_run(name):
    schedule = nested if name == "nested" else SCHEDULES[name]
    main, startup, loss, lr = build(tfluid, schedule, opt="adam")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    arrays = {n: scope.as_numpy(n) for n in scope.vars}
    want = [[np.asarray(v) for v in exe.run(
        main, feed=feed(i), fetch_list=[loss, lr, COUNTER], scope=scope)]
        for i in range(8)]
    main._tpu_step_counter = 0
    other = tfluid.io.state_from_numpy(main, arrays, tfluid.Scope(),
                                       tfluid.CPUPlace())
    got = exe.run_steps(main, [feed(i) for i in range(8)],
                        fetch_list=[loss, lr, COUNTER], fetch_every=4,
                        scope=other)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert int(other.as_numpy(COUNTER)[0]) == int(want[-1][2][0])
    for n in arrays:
        np.testing.assert_array_equal(other.as_numpy(n), scope.as_numpy(n))


def test_pass_pipeline_keeps_the_increment(monkeypatch):
    from paddle_tpu_torch.passes.pipeline import optimize_program

    main, startup, loss, lr = build(tfluid, nested)
    opt = optimize_program(main, (loss.name, lr.name), None, level=1)
    types_ = [op.type for op in opt.global_block.ops]
    assert types_.count("increment") == 1
    assert "less_than" in types_ and "where" in types_
    runs = {}
    for level in ("0", "1"):
        monkeypatch.setenv("PADDLE_TPU_OPT_LEVEL", level)
        (losses, rates, counters), _, _ = port_run(nested, steps=6)
        runs[level] = (rates, counters)
    assert runs["0"] == runs["1"]


def test_cycle_is_ignored_as_in_the_jax_package():
    def cyc(L):
        return L.polynomial_decay(0.1, 3, 0.01, cycle=True)

    (_, rates, _), _, _ = port_run(cyc, steps=6)
    want = [(0.1 - 0.01) * (1 - min(s, 3) / 3) + 0.01 for s in range(6)]
    np.testing.assert_allclose(rates, want, rtol=1e-6)


def test_cosine_decay_closed_form():
    (_, rates, counters), _, _ = port_run(SCHEDULES["cosine_decay"])
    want = [0.05 * (1 + math.cos(math.pi * math.floor(s / 2) / 6))
            for s in counters]
    np.testing.assert_allclose(rates, want, rtol=1e-6, atol=1e-8)
