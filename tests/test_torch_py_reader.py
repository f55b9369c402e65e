"""py_reader on the port (reference contract: layers/io.py:636 py_reader +
test_py_reader_using_executor.py), the scenarios of the JAX package's
``tests/test_py_reader.py``: reader-fed training equals feed-dict training
(and the JAX package's reader-fed run within 1e-5 from its startup
weights), epochs restart after ``reset()``, a source error reaches the
caller, a full explicit feed wins and a partial one raises, and an
unstarted reader feeds nothing. Then ``run_steps(feed_iter=None)`` drains
the started readers to EOF, a ``DevicePrefetcher`` that ``run_steps``
starts is stopped at an early ``steps``, one the caller started stays
running, and a final partial batch resolves a second captured step.

The readers prefetch on the CPU here (``places=fluid.CPUPlace()``).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.reader import DevicePrefetcher

CPU = tfluid.CPUPlace()


def build(fluid, via_reader, dim=16, classes=4, double_buffer=True):
    if via_reader:
        reader = fluid.layers.py_reader(
            capacity=8, shapes=[[-1, dim], [-1, 1]],
            dtypes=["float32", "int64"], name="train_reader",
            use_double_buffer=double_buffer)
        img, label = fluid.layers.read_file(reader)
    else:
        reader = None
        img = fluid.layers.data("img", shape=[dim])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
    h = fluid.layers.fc(img, size=32, act="relu",
                        param_attr=fluid.ParamAttr(name="w1"),
                        bias_attr=fluid.ParamAttr(name="b1"))
    logits = fluid.layers.fc(h, size=classes,
                             param_attr=fluid.ParamAttr(name="w2"),
                             bias_attr=fluid.ParamAttr(name="b2"))
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return reader, loss


def programs(fluid, via_reader, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        reader, loss = build(fluid, via_reader, **kw)
    return main, startup, reader, loss


def data(n=64, dim=16, classes=4, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, dim).astype("float32")
    ys = rng.randint(0, classes, (n, 1)).astype("int64")
    return [(xs[i:i + batch], ys[i:i + batch]) for i in range(0, n, batch)]


def jax_start():
    """The JAX startup's weights (w1, b1, w2, b2) as numpy."""
    main, startup, _, _ = programs(jfluid, False)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return {n: np.asarray(v) for n, v in scope.vars.items()}


def drain(exe, main, reader, loss, scope):
    out = []
    reader.start()
    with pytest.raises(tfluid.core.EOFException):
        while True:
            out.append(float(exe.run(main, fetch_list=[loss],
                                     scope=scope)[0]))
    reader.reset()
    return out


@pytest.mark.parametrize("double_buffer", [True, False])
def test_reader_fed_equals_feed_dict_and_jax(double_buffer):
    batches = data()
    arrays = jax_start()
    # the JAX package's reader-fed run from its startup
    jm, js, jr, jloss = programs(jfluid, True)
    jr.decorate_tensor_provider(lambda: iter(batches))
    with jfluid.scope_guard(jfluid.Scope()) as _:
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        scope = jfluid.global_scope()
        for n, v in arrays.items():
            scope.set_var(n, v)
        jr.start()
        want = []
        with pytest.raises(jfluid.core.EOFException):
            while True:
                want.append(float(jexe.run(jm, fetch_list=[jloss])[0]))
        jr.reset()

    exe = tfluid.Executor(CPU)
    fm, _, _, floss = programs(tfluid, False)
    fscope = tfluid.io.state_from_numpy(fm, arrays, tfluid.Scope(), CPU)
    fed = [float(exe.run(fm, feed={"img": x, "label": y}, fetch_list=[floss],
                         scope=fscope)[0]) for x, y in batches]
    tm, _, reader, tloss = programs(tfluid, True,
                                    double_buffer=double_buffer)
    reader.decorate_tensor_provider(lambda: iter(batches), places=CPU)
    tscope = tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(), CPU)
    got = drain(exe, tm, reader, tloss, tscope)
    assert got == fed
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for n in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(tscope.as_numpy(n), fscope.as_numpy(n),
                                   rtol=0, atol=0)


def started(main, startup):
    scope = tfluid.Scope()
    tfluid.Executor(CPU).run(startup, scope=scope)
    return scope


def clone(scope):
    out = tfluid.Scope()
    for k, v in scope.vars.items():
        out.set_var(k, v.clone())
    return out


def test_epoch_restart():
    main, startup, reader, loss = programs(tfluid, True)
    reader.decorate_tensor_provider(lambda: iter(data(n=32)), places=CPU)
    scope = started(main, startup)
    exe = tfluid.Executor(CPU)
    assert sum(len(drain(exe, main, reader, loss, scope))
               for _ in range(3)) == 6


def test_paddle_reader_decoration_stacks_samples():
    main, startup, reader, loss = programs(tfluid, True)

    def batched_samples():
        r = np.random.RandomState(0)
        for _ in range(3):
            yield [(r.randn(16).astype("float32"),
                    r.randint(0, 4, (1,)).astype("int64")) for _ in range(8)]

    reader.decorate_paddle_reader(batched_samples, places=CPU)
    scope = started(main, startup)
    assert len(drain(tfluid.Executor(CPU), main, reader, loss, scope)) == 3


def test_book_reader_through_py_reader():
    """``fluid.reader.batch(fluid.dataset.uci_housing.train(), 101)`` fed
    through ``decorate_sample_list_generator`` equals a ``DataFeeder`` of
    the same batches."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        reader = tfluid.layers.py_reader(
            capacity=4, shapes=[[-1, 13], [-1, 1]],
            dtypes=["float32", "float32"])
        x, y = tfluid.layers.read_file(reader)
        pred = tfluid.layers.fc(x, 1)
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
        tfluid.optimizer.SGD(0.01).minimize(loss)
    batched = tfluid.reader.batch(tfluid.dataset.uci_housing.train(), 101)
    reader.decorate_sample_list_generator(batched, places=[CPU])
    exe = tfluid.Executor(CPU)
    scope = started(main, startup)
    s2 = clone(scope)
    feeder = tfluid.DataFeeder([x, y], CPU)
    want = [float(exe.run(main, feed=feeder.feed(b), fetch_list=[loss],
                          scope=s2)[0]) for b in batched()]
    assert drain(exe, main, reader, loss, scope) == want and len(want) == 4


def test_source_error_propagates():
    main, startup, reader, loss = programs(tfluid, True)

    def bad():
        yield (np.zeros((4, 16), "float32"), np.zeros((4, 1), "int64"))
        raise ValueError("synthetic reader failure")

    reader.decorate_tensor_provider(bad, places=CPU)
    scope = started(main, startup)
    exe = tfluid.Executor(CPU)
    reader.start()
    exe.run(main, fetch_list=[loss], scope=scope)
    with pytest.raises(ValueError, match="synthetic reader failure"):
        while True:
            exe.run(main, fetch_list=[loss], scope=scope)


def test_explicit_feed_wins_over_reader():
    main, startup, reader, loss = programs(tfluid, True)
    img, lab = reader.var_names
    qx, qy = np.zeros((4, 16), "float32"), np.zeros((4, 1), "int64")
    reader.decorate_tensor_provider(lambda: iter([(qx, qy)] * 2), places=CPU)
    scope = started(main, startup)
    exe = tfluid.Executor(CPU)
    reader.start()
    cx = np.random.RandomState(1).randn(4, 16).astype("float32")
    cy = np.ones((4, 1), "int64")
    got, = exe.run(main, feed={img: cx, lab: cy}, fetch_list=[lab],
                   scope=scope)
    np.testing.assert_array_equal(got, cy)
    with pytest.raises(ValueError, match="feed all of them or none"):
        exe.run(main, feed={lab: cy}, fetch_list=[lab], scope=scope)
    reader.reset()


def test_reader_requires_start():
    main, startup, reader, loss = programs(tfluid, True)
    reader.decorate_tensor_provider(lambda: iter([]), places=CPU)
    scope = started(main, startup)
    from paddle_tpu_torch.core.enforce import EnforceNotMet

    with pytest.raises(EnforceNotMet, match="not materialized"):
        tfluid.Executor(CPU).run(main, fetch_list=[loss], scope=scope)
    with pytest.raises(RuntimeError, match="not started"):
        reader.next_feed()
    with pytest.raises(RuntimeError, match="no data source"):
        tfluid.layers.py_reader(2, [[-1, 2]], ["float32"]).start()


def test_double_buffer_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default place is valid here")
    main, startup, reader, loss = programs(tfluid, True)
    reader.decorate_tensor_provider(lambda: iter(data()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        reader.start()


def test_run_steps_drains_readers_to_eof():
    batches = data(n=80)
    main, startup, reader, loss = programs(tfluid, True)
    reader.decorate_tensor_provider(lambda: iter(batches), places=CPU)
    scope = started(main, startup)
    s2 = clone(scope)
    exe = tfluid.Executor(CPU)
    reader.start()
    rows = exe.run_steps(main, None, fetch_list=[loss], fetch_every=2,
                         scope=scope)
    img, lab = reader.var_names
    want = exe.run_steps(main, [{img: x, lab: y} for x, y in batches],
                         fetch_list=[loss], fetch_every=2, scope=s2)
    assert len(rows) == 5 and [float(r[0]) for r in rows] == \
        [float(r[0]) for r in want]
    with pytest.raises(ValueError, match="feed_iter"):
        exe.run_steps(main, None, fetch_list=[loss], scope=scope)


def test_run_steps_owns_the_prefetcher_it_starts():
    main, startup, _, loss = programs(tfluid, False)
    scope = started(main, startup)
    feeds = [{"img": x, "label": y} for x, y in data(n=160)]
    exe = tfluid.Executor(CPU)
    owned = DevicePrefetcher(iter(feeds), capacity=2, device="cpu")
    rows = exe.run_steps(main, owned, steps=3, fetch_list=[loss],
                         scope=scope)
    assert len(rows) == 3
    assert owned._stop.is_set() and not owned._thread.is_alive()
    mine = DevicePrefetcher(iter(feeds), capacity=2, device="cpu").start()
    exe.run_steps(main, mine, steps=3, fetch_list=[loss], scope=scope)
    assert not mine._stop.is_set() and mine._thread.is_alive()
    assert len(exe.run_steps(main, mine, fetch_list=[loss],
                             scope=scope)) == 7
    mine.stop()


def test_partial_final_batch_resolves_a_second_step():
    main, startup, reader, loss = programs(tfluid, True)
    batches = data(n=72)  # 4 batches of 16, then one of 8
    reader.decorate_tensor_provider(lambda: iter(batches), places=CPU)
    scope = started(main, startup)
    s2 = clone(scope)
    exe = tfluid.Executor(CPU)
    reader.start()
    rows = exe.run_steps(main, None, fetch_list=[loss], fetch_every=4,
                         scope=scope)
    assert len(rows) == 5 and len(exe._captured) == 2
    shapes = sorted(cap.sig[0][1] for cap in exe._captured.values())
    assert shapes == [(8, 16), (16, 16)]
    texe = tfluid.Executor(CPU)
    img, lab = reader.var_names
    want = [float(texe.run(main, feed={img: x, lab: y}, fetch_list=[loss],
                           scope=s2)[0]) for x, y in batches]
    assert [float(r[0]) for r in rows] == want
