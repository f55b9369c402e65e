"""Gradient accumulation in the port (``BuildStrategy.gradient_accumulation_steps``),
on the CPU, against the JAX package.

A ``CompiledProgram`` whose build strategy asks for ``accum`` microbatches
splits every feed along dim 0, runs the forward and its gradient once per
microbatch from the step's state, sums the gradients and divides by
``accum``, and runs the optimizer ops once, on the last microbatch's env
with the mean of the microbatch losses (``Executor._train_step``). Held
here:

* accumulation 4 trains as the full batch does (the JAX package's
  ``tests/test_parallel_mesh.py`` test: MLP, SGD, rtol 1e-4, atol 1e-5);
* against the JAX package with accumulation 2, from its startup state
  (``io.state_from_numpy``), dropout 0: an MLP under SGD and a 2-layer
  Transformer under Adam, losses 1e-5 and each state var 1e-5 norm-wise;
* batch-norm moving statistics after accumulated steps equal the JAX
  package's, and are the last microbatch's (bit-equal to a step on that
  microbatch alone);
* ``run_steps`` with accumulation is bit-equal to ``run()`` (dropout on);
* ``is_sparse`` tables with accumulation raise, and so does a batch the
  count does not divide.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as jtfm
from paddle_tpu_torch.models import deepfm as tdfm
from paddle_tpu_torch.models import transformer as ttfm

CPU = tfluid.CPUPlace()


def compiled(fluid, main, loss, accum, places=None):
    bs = fluid.BuildStrategy()
    bs.gradient_accumulation_steps = accum
    return fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs, places=places)


def jax_start(startup):
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return scope


def port_from(main, jscope):
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
    return tfluid.io.state_from_numpy(main, arrays, tfluid.Scope(), CPU)


def jax_steps(main, loss, scope, feeds, accum):
    prog = compiled(jfluid, main, loss, accum, places=[jfluid.CPUPlace()])
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        return [float(np.asarray(exe.run(prog, feed=f, fetch_list=[loss])[0])
                      .ravel()[0]) for f in feeds]


def port_steps(main, loss, scope, feeds, accum):
    prog = compiled(tfluid, main, loss, accum)
    exe = tfluid.Executor(CPU)
    return [float(np.ravel(exe.run(prog, feed=f, fetch_list=[loss],
                                   scope=scope)[0])[0]) for f in feeds]


def assert_state_close(tmain, tscope, jscope, tol=1e-5):
    """Each persistable var within ``tol`` norm-wise: Adam divides by the
    root of the second moment, so an element with a gradient near 0 moves
    by a rounding-sized step and differs more than 1e-5 relative alone."""
    names = [v.name for v in tmain.list_vars() if v.persistable]
    assert names
    for n in names:
        got = tscope.as_numpy(n).astype(np.float64)
        want = np.asarray(jscope.vars[n]).astype(np.float64)
        assert got.shape == want.shape, n
        err = np.linalg.norm(got - want)
        assert err <= tol * max(np.linalg.norm(want), 1e-12), (n, err)


# -- programs -----------------------------------------------------------------


def mlp(fluid, dropout=0.0, opt="sgd"):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[16])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, size=32, act="relu")
        if dropout:
            h = fluid.layers.dropout(
                h, dropout, dropout_implementation="upscale_in_train")
        logits = fluid.layers.fc(h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        (fluid.optimizer.SGD(0.1) if opt == "sgd"
         else fluid.optimizer.Adam(1e-2)).minimize(loss)
    return main, startup, loss


def mlp_feeds(n, batch=32, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(batch, 16).astype("float32"),
             "y": rng.randint(0, 4, (batch, 1)).astype("int64")}
            for _ in range(n)]


def transformer(fluid, tfm, seq=8, vocab=50):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ins = [fluid.layers.data(n, shape=[seq], dtype="int64")
               for n in ("src", "trg")]
        lbl = fluid.layers.data("lbl", shape=[seq, 1], dtype="int64")
        masks = [fluid.layers.data(n, shape=[seq], dtype="float32")
                 for n in ("smask", "tmask")]
        _, loss = tfm.transformer(*ins, lbl, *masks, vocab, vocab,
                                  max_length=seq, n_layer=2, n_head=2,
                                  d_model=32, d_inner=64, dropout_rate=0.0)
        fluid.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss


def transformer_feeds(n, batch=4, seq=8, vocab=50):
    rng = np.random.RandomState(3)
    out = []
    for _ in range(n):
        mask = np.ones((batch, seq), "float32")
        mask[0, seq // 2:] = 0.0
        out.append({
            "src": rng.randint(2, vocab, (batch, seq)).astype("int64"),
            "trg": rng.randint(2, vocab, (batch, seq)).astype("int64"),
            "lbl": rng.randint(2, vocab, (batch, seq, 1)).astype("int64"),
            "smask": mask, "tmask": mask.copy()})
    return out


def conv_bn(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", shape=[3, 6, 6])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        c = fluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                bias_attr=False)
        h = fluid.layers.batch_norm(c, act="relu", momentum=0.8)
        logits = fluid.layers.fc(h, size=3)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Momentum(0.05, 0.9).minimize(loss)
    return main, startup, loss


def conv_bn_feeds(n, batch=8):
    rng = np.random.RandomState(5)
    return [{"img": rng.randn(batch, 3, 6, 6).astype("float32") + i,
             "y": rng.randint(0, 3, (batch, 1)).astype("int64")}
            for i in range(n)]


# -- tests --------------------------------------------------------------------


def test_accumulation_matches_the_full_batch():
    feeds = mlp_feeds(1) * 4
    out = {}
    for accum in (1, 4):
        main, startup, loss = mlp(tfluid)
        scope = tfluid.Scope()
        tfluid.Executor(CPU).run(startup, scope=scope)
        out[accum] = port_steps(main, loss, scope, feeds, accum)
    np.testing.assert_allclose(out[1], out[4], rtol=1e-4, atol=1e-5)
    assert out[4][-1] < out[4][0]


@pytest.mark.parametrize("model", ["mlp_sgd", "transformer_adam"])
def test_accumulation_matches_the_jax_package(model):
    if model == "mlp_sgd":
        jm, js, jl = mlp(jfluid)
        tm, ts, tl = mlp(tfluid)
        feeds = mlp_feeds(3, batch=16)
    else:
        jm, js, jl = transformer(jfluid, jtfm)
        tm, ts, tl = transformer(tfluid, ttfm)
        feeds = transformer_feeds(3)
    jscope = jax_start(js)
    tscope = port_from(tm, jscope)
    want = jax_steps(jm, jl, jscope, feeds, 2)
    got = port_steps(tm, tl, tscope, feeds, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_state_close(tm, tscope, jscope)


def test_batch_norm_statistics_are_the_last_microbatchs():
    jm, js, jl = conv_bn(jfluid)
    tm, ts, tl = conv_bn(tfluid)
    feeds = conv_bn_feeds(2)
    jscope = jax_start(js)
    tscope = port_from(tm, jscope)
    start = port_from(tm, jscope)
    want = jax_steps(jm, jl, jscope, feeds, 2)
    got = port_steps(tm, tl, tscope, feeds[:1], 2)
    np.testing.assert_allclose(got, want[:1], rtol=1e-5)
    stats = [v.name for v in tm.list_vars()
             if v.persistable and (".mean_" in v.name or ".var_" in v.name)]
    assert len(stats) == 2
    # one plain step on the last microbatch alone, from the same start
    last = {n: v[4:] for n, v in feeds[0].items()}
    tfluid.Executor(CPU).run(tm, feed=last, fetch_list=[tl], scope=start)
    for n in stats:
        np.testing.assert_array_equal(tscope.as_numpy(n), start.as_numpy(n),
                                      err_msg=n)
    port_steps(tm, tl, tscope, feeds[1:], 2)
    assert_state_close(tm, tscope, jscope)


def test_run_steps_with_accumulation_is_bit_equal_to_run():
    feeds = mlp_feeds(5, batch=12, seed=1)
    rows = {}
    for how in ("run", "run_steps"):
        main, startup, loss = mlp(tfluid, dropout=0.2, opt="adam")
        scope = tfluid.Scope()
        exe = tfluid.Executor(CPU)
        exe.run(startup, scope=scope)
        prog = compiled(tfluid, main, loss, 3)
        if how == "run":
            rows[how] = [exe.run(prog, feed=f, fetch_list=[loss], scope=scope)
                         for f in feeds]
        else:
            rows[how] = exe.run_steps(prog, feeds, fetch_list=[loss],
                                      fetch_every=2, scope=scope)
        rows[how + "_state"] = {n: scope.as_numpy(n) for n in scope.vars}
    for a, b in zip(rows["run"], rows["run_steps"]):
        np.testing.assert_array_equal(a[0], b[0])
    for n, v in rows["run_state"].items():
        np.testing.assert_array_equal(v, rows["run_steps_state"][n])


def test_sparse_tables_with_accumulation_raise():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        ids = tfluid.layers.data("ids", shape=[4], dtype="int64")
        dense = tfluid.layers.data("dense", shape=[3], dtype="float32")
        label = tfluid.layers.data("label", shape=[1], dtype="float32")
        loss, _, _ = tdfm.deepfm(ids, dense, label, sparse_feature_dim=50,
                                 num_fields=4, embedding_size=4,
                                 layer_sizes=(8,))
        tfluid.optimizer.Adam(1e-3).minimize(loss)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(0, 50, (8, 4)).astype("int64"),
            "dense": rng.rand(8, 3).astype("float32"),
            "label": rng.randint(0, 2, (8, 1)).astype("float32")}
    with pytest.raises(NotImplementedError, match="is_sparse"):
        exe.run(compiled(tfluid, main, loss, 2), feed=feed,
                fetch_list=[loss], scope=scope)


def test_a_batch_the_count_does_not_divide_raises():
    main, startup, loss = mlp(tfluid)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="does not divide"):
        exe.run(compiled(tfluid, main, loss, 5), feed=mlp_feeds(1)[0],
                fetch_list=[loss], scope=scope)
