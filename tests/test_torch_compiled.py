"""The port's ``CompiledProgram``, ``Executor.run_steps`` and
``FetchHandle`` on the CPU.

On the card both run the captured step (a CUDA graph of the eager step);
on the CPU the same calls run the same step body step by step, so all but
the graph is held here (the graph: ``tests/test_torch_captured_cuda.py``):

* ``BuildStrategy``/``ExecutionStrategy`` have the JAX package's knobs and
  defaults; an inert knob warns once; what the port lacks raises with its
  ROADMAP pointer, and what it refuses as the JAX package does raises;
* ``run_steps`` rows are bit-equal to per-step ``run()`` from the same
  start (dropout 0.1 on: each step its own masks), at several
  ``fetch_every``; handles stack a chunk's fetches on a leading axis; a
  partial final batch, feed exhaustion, interleaving with ``run()``, a
  feed source that raises and a program edit behave as in the JAX package;
* ``accuracy``'s ``Total`` is the JAX package's;
* against the JAX package, from its startup state (carried by
  ``io.state_from_numpy``), dropout 0: tiny BERT and an MLP with
  ``Momentum`` through ``run_steps`` (``fetch_every=4``, 8 steps), tiny
  DeepFM with ``is_sparse`` tables and Adam, and
  ``CompiledProgram(main).with_data_parallel`` through ``run()``: losses
  to 1e-5 (float32, another summation order), DeepFM's state to rtol
  1e-4 + atol 1e-6 as in ``tests/test_torch_deepfm.py``.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.flags import set_flag
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import deepfm as jdfm
from paddle_tpu.models import mnist as jmn
from paddle_tpu_torch.executor import FeedError
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import deepfm as tdfm
from paddle_tpu_torch.models import mnist as tmn

CPU = tfluid.CPUPlace()


# -- programs -----------------------------------------------------------------


def mlp_dropout(fluid=tfluid):
    """A small classifier with dropout 0.1 between its layers, Adam."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[8])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 16, act="relu")
        h = fluid.layers.dropout(h, 0.1,
                                 dropout_implementation="upscale_in_train")
        logits = fluid.layers.fc(h, 4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


def mlp_feeds(n, batch=6, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(batch, 8).astype("float32"),
             "y": rng.randint(0, 4, (batch, 1)).astype("int64")}
            for _ in range(n)]


def bert_pretrain(fluid, bert, dropout, s=16, n_mask=3):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ins = [fluid.layers.data(n, shape=[s], dtype="int64")
               for n in ("ids", "pos", "sent")]
        mask = fluid.layers.data("mask", shape=[s], dtype="float32")
        mpos = fluid.layers.data("mpos", shape=[n_mask], dtype="int64")
        mlbl = fluid.layers.data("mlbl", shape=[1], dtype="int64")
        nsp = fluid.layers.data("nsp", shape=[1], dtype="int64")
        loss, _, _ = bert.bert_pretrain(*ins, mask, mpos, mlbl, nsp,
                                        dropout_rate=dropout,
                                        **bert.BERT_TINY_CONFIG)
        fluid.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss


def bert_feeds(n, b=4, s=16, n_mask=3):
    vocab = tbert.BERT_TINY_CONFIG["vocab_size"]
    feeds = []
    for seed in range(n):
        rng = np.random.RandomState(seed)
        feeds.append({
            "ids": rng.randint(0, vocab, (b, s)).astype("int64"),
            "pos": np.tile(np.arange(s), (b, 1)).astype("int64"),
            "sent": rng.randint(0, 2, (b, s)).astype("int64"),
            "mask": (rng.rand(b, s) > 0.2).astype("float32"),
            "mpos": (np.arange(b)[:, None] * s
                     + rng.randint(0, s, (b, n_mask))).astype("int64"),
            "mlbl": rng.randint(0, vocab, (b * n_mask, 1)).astype("int64"),
            "nsp": rng.randint(0, 2, (b, 1)).astype("int64")})
    return feeds


def mnist_momentum(fluid, mn):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", shape=[784])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        _, loss, acc = mn.mlp(img, label)
        fluid.optimizer.Momentum(1e-3, 0.9).minimize(loss)
    return main, startup, loss, acc


def mnist_feeds(n, batch=16):
    rng = np.random.RandomState(0)
    centers = rng.randn(10, 784).astype("float32") * 3.0
    feeds = []
    for _ in range(n):
        ys = rng.randint(0, 10, size=batch)
        xs = centers[ys] + rng.randn(batch, 784).astype("float32") * 0.5
        feeds.append({"img": xs.astype("float32"),
                      "label": ys.reshape(-1, 1).astype("int64")})
    return feeds


def deepfm(fluid, dfm):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[8], dtype="int64")
        dense = fluid.layers.data("dense", shape=[13])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        _, loss, _ = dfm.deepfm(ids, dense, label, sparse_feature_dim=1000,
                                embedding_size=4, num_fields=8,
                                layer_sizes=(16, 16), is_sparse=True)
        fluid.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss


def deepfm_feeds(n):
    rng = np.random.RandomState(0)
    return [{"ids": rng.randint(0, 1000, (32, 8)).astype("int64"),
             "dense": rng.rand(32, 13).astype("float32"),
             "label": rng.randint(0, 2, (32, 1)).astype("int64")}
            for _ in range(n)]


# -- helpers ------------------------------------------------------------------


def started(startup):
    scope = tfluid.Scope()
    tfluid.Executor(CPU).run(startup, scope=scope)
    return scope


def copy_of(scope):
    out = tfluid.Scope()
    for n, v in scope.vars.items():
        out.set_var(n, v.clone())
    return out


def eager_rows(main, scope, feeds, fetch):
    exe = tfluid.Executor(CPU)
    return [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]


def assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def assert_scopes_equal(a, b):
    assert set(a.vars) == set(b.vars)
    for n in a.vars:
        np.testing.assert_array_equal(a.as_numpy(n), b.as_numpy(n),
                                      err_msg=n)


def from_jax(jm, js, tm):
    """Run the JAX startup; return (JAX scope, port scope with its state)."""
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(js)
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
    return jscope, tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(),
                                              CPU)


# -- strategies ---------------------------------------------------------------


@pytest.mark.parametrize("cls", ["ExecutionStrategy", "BuildStrategy"])
def test_strategy_defaults_are_the_jax_packages(cls):
    got, want = getattr(tfluid, cls)(), getattr(jfluid, cls)()
    assert got._defaults == want._defaults
    assert {k: getattr(got, k) for k in got._defaults} == \
        {k: getattr(want, k) for k in want._defaults}
    assert set(got._INERT) == set(want._INERT)


def test_strategy_enums_are_the_jax_packages():
    for enum in ("ReduceStrategy", "GradientScaleStrategy"):
        got = getattr(tfluid.BuildStrategy, enum)
        want = getattr(jfluid.BuildStrategy, enum)
        assert {k: v for k, v in vars(got).items() if not k.startswith("_")} \
            == {k: v for k, v in vars(want).items() if not k.startswith("_")}


INERT = [("ExecutionStrategy", "num_threads", 4),
         ("ExecutionStrategy", "num_iteration_per_drop_scope", 10),
         ("ExecutionStrategy", "use_experimental_executor", True),
         ("BuildStrategy", "memory_optimize", False),
         ("BuildStrategy", "enable_inplace", False),
         ("BuildStrategy", "fuse_all_reduce_ops", False),
         ("BuildStrategy", "gradient_scale_strategy", 1)]


@pytest.mark.parametrize("cls,knob,value", INERT)
def test_inert_knob_warns_once_with_the_ports_reason(cls, knob, value):
    strategy = getattr(tfluid, cls)()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        setattr(strategy, knob, strategy._defaults[knob])
        assert not caught
        setattr(strategy, knob, value)
    assert len(caught) == 1
    msg = str(caught[0].message)
    assert knob in msg and "no effect" in msg and "XLA" not in msg
    assert getattr(strategy, knob) == value


def test_honoured_knobs_do_not_warn():
    bs = tfluid.BuildStrategy()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bs.reduce_strategy = tfluid.BuildStrategy.ReduceStrategy.Reduce
        bs.num_trainers = 1
        bs.gradient_accumulation_steps = 1


def _refuse_mesh(main, exe, scope):
    tfluid.CompiledProgram(main).with_mesh({"data": 2})


def _refuse_places(main, exe, scope):
    tfluid.CompiledProgram(main).with_data_parallel(places=[CPU, CPU])


def _refuse_accumulation(main, exe, scope):
    bs = tfluid.BuildStrategy()
    bs.gradient_accumulation_steps = 4
    prog = tfluid.CompiledProgram(main).with_data_parallel(build_strategy=bs)
    exe.run(prog, feed=mlp_feeds(1)[0], scope=scope)  # batch 6


def _refuse_pass_builder(main, exe, scope):
    tfluid.BuildStrategy().pass_builder().append_pass("no_such_pass")


# Gradient accumulation and the pass builder are ported; what they still
# refuse, as the JAX package does, is a batch the microbatch count does
# not divide and a pass that is not registered.
@pytest.mark.parametrize("refusal,error,pointer", [
    (_refuse_mesh, NotImplementedError, "Queue 1 item 7"),
    (_refuse_places, NotImplementedError, "Queue 1 item 7"),
    (_refuse_accumulation, ValueError, "does not divide"),
    (_refuse_pass_builder, KeyError, "not registered")],
    ids=["with_mesh", "two_places", "accumulation", "pass_builder"])
def test_what_the_port_lacks_raises_with_its_roadmap_pointer(refusal, error,
                                                             pointer):
    main, startup, _ = mlp_dropout()
    scope = started(startup)
    with pytest.raises(error, match=pointer):
        refusal(main, tfluid.Executor(CPU), scope)


def test_reduce_strategy_and_one_place_run_as_the_plain_step():
    main, startup, loss = mlp_dropout()
    scope = started(startup)
    ref = copy_of(scope)
    bs = tfluid.BuildStrategy()
    bs.reduce_strategy = tfluid.BuildStrategy.ReduceStrategy.Reduce
    prog = tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs, places=[CPU])
    feeds = mlp_feeds(3)
    step0 = getattr(main, "_tpu_step_counter", 0)
    exe = tfluid.Executor(CPU)
    got = [exe.run(prog, feed=f, fetch_list=[loss], scope=scope)
           for f in feeds]
    main._tpu_step_counter = step0
    assert_rows_equal(got, eager_rows(main, ref, feeds, [loss]))


# -- run_steps ----------------------------------------------------------------


@pytest.mark.parametrize("fetch_every", [1, 3, 8])
def test_run_steps_rows_are_bit_equal_to_run_with_dropout(fetch_every):
    main, startup, loss = mlp_dropout()
    scope = started(startup)
    ref = copy_of(scope)
    feeds = mlp_feeds(8)
    step0 = getattr(main, "_tpu_step_counter", 0)
    want = eager_rows(main, ref, feeds, [loss])
    main._tpu_step_counter = step0
    exe = tfluid.Executor(CPU)
    got = exe.run_steps(main, feeds, fetch_list=[loss],
                        fetch_every=fetch_every, scope=scope)
    assert_rows_equal(got, want)
    assert_scopes_equal(scope, ref)
    assert main._tpu_step_counter == step0 + 8
    assert len({float(w[0]) for w in want}) == 8


def test_run_steps_bert_tiny_is_bit_equal_to_run_with_dropout():
    main, startup, loss = bert_pretrain(tfluid, tbert, dropout=0.1)
    scope = started(startup)
    ref = copy_of(scope)
    feeds = bert_feeds(5)
    want = eager_rows(main, ref, feeds, [loss])
    main._tpu_step_counter = 0
    got = tfluid.Executor(CPU).run_steps(main, feeds, fetch_list=[loss],
                                         fetch_every=4, scope=scope)
    assert_rows_equal(got, want)
    assert_scopes_equal(scope, ref)


def test_handles_stack_a_chunks_fetches_on_a_leading_axis():
    main, startup, loss = mlp_dropout()
    scope = started(startup)
    ref = copy_of(scope)
    feeds = mlp_feeds(7)
    want = eager_rows(main, ref, feeds, [loss, "fc_0.w_0"])
    main._tpu_step_counter = 0
    hs = tfluid.Executor(CPU).run_steps(
        main, feeds, fetch_list=[loss, "fc_0.w_0"], fetch_every=3,
        scope=scope, return_numpy=False)
    assert [len(h) for h in hs] == [2, 2, 2]
    assert [tuple(h.raw[1].shape) for h in hs] == [(3, 8, 16), (3, 8, 16),
                                                   (8, 16)]
    assert hs[0].names == (loss.name, "fc_0.w_0")
    assert all(h.done() for h in hs)
    lv, w = hs[0]
    assert isinstance(lv, torch.Tensor) and lv.shape[0] == 3
    np.testing.assert_array_equal(np.asarray(hs[1][0]),
                                  np.stack([r[0] for r in want[3:6]]))
    np.testing.assert_array_equal(hs[2].block().numpy()[1], want[6][1])


def test_a_partial_final_batch_resolves_a_new_captured_step():
    main, startup, loss = mlp_dropout()
    scope = started(startup)
    ref = copy_of(scope)
    feeds = mlp_feeds(5) + mlp_feeds(1, batch=4, seed=9)
    want = eager_rows(main, ref, feeds, [loss])
    main._tpu_step_counter = 0
    exe = tfluid.Executor(CPU)
    hs = exe.run_steps(main, feeds, fetch_list=[loss], fetch_every=4,
                       scope=scope, return_numpy=False)
    assert [tuple(h.raw[0].shape) for h in hs] == [(4,), (), ()]
    assert len(exe._captured) == 2
    assert_rows_equal([[a] for h in hs for a in np.atleast_1d(h.numpy()[0])],
                      want)
    assert_scopes_equal(scope, ref)


def test_steps_none_runs_until_the_feeds_are_exhausted():
    main, startup, loss = mlp_dropout()
    scope = started(startup)
    feeds = mlp_feeds(5)
    rows = tfluid.Executor(CPU).run_steps(main, (f for f in feeds),
                                          fetch_list=[loss], fetch_every=2,
                                          scope=scope)
    assert len(rows) == 5
    rows = tfluid.Executor(CPU).run_steps(main, iter(feeds), steps=3,
                                          fetch_list=[loss], fetch_every=2,
                                          scope=scope)
    assert len(rows) == 3


def test_run_steps_interleaves_with_run():
    """Mirrors the JAX package's ``test_run_steps_interleaves_with_run``:
    an eager ``run()`` between chunks replaces the scope's tensors; the next
    chunk copies them back into its static state."""
    main, startup, loss = mlp_dropout()
    scope = started(startup)
    ref = copy_of(scope)
    feeds = mlp_feeds(8)
    want = eager_rows(main, ref, feeds, [loss])
    main._tpu_step_counter = 0
    exe = tfluid.Executor(CPU)
    got = exe.run_steps(main, feeds[:3], fetch_list=[loss], fetch_every=2,
                        scope=scope)
    got += [exe.run(main, feed=f, fetch_list=[loss], scope=scope)
            for f in feeds[3:5]]
    got += exe.run_steps(main, feeds[5:], fetch_list=[loss], fetch_every=2,
                         scope=scope)
    assert_rows_equal(got, want)
    assert_scopes_equal(scope, ref)


def test_a_feed_source_that_raises_is_a_feed_error():
    main, startup, loss = mlp_dropout()
    scope = started(startup)

    def broken():
        yield from mlp_feeds(3)
        raise OSError("shard unreadable")

    exe = tfluid.Executor(CPU)
    with pytest.raises(FeedError, match="global step 3 .*OSError"):
        exe.run_steps(main, broken(), fetch_list=[loss], fetch_every=2,
                      scope=scope)
    bad = mlp_feeds(1)[0]
    bad["x"] = [[1.0, 2.0], [3.0]]
    with pytest.raises(FeedError, match="could not be converted"):
        exe.run_steps(main, [bad], fetch_list=[loss], scope=scope)


def test_run_steps_without_feeds_raises_value_error():
    main, _, loss = mlp_dropout()
    with pytest.raises(ValueError, match="feed_iter"):
        tfluid.Executor(CPU).run_steps(main, None, steps=2,
                                       fetch_list=[loss])


def test_a_program_edit_resolves_a_new_captured_step():
    main, startup, loss = mlp_dropout()
    scope = started(startup)
    exe = tfluid.Executor(CPU)
    exe.run_steps(main, mlp_feeds(3), fetch_list=[loss], scope=scope)
    (cap,) = exe._captured.values()
    version = main._version
    main.random_seed = 11
    assert main._version > version
    exe.run_steps(main, mlp_feeds(3), fetch_list=[loss], scope=scope)
    assert len(exe._captured) == 2 and cap in exe._captured.values()
    exe.close()
    assert not exe._captured and not exe._plans


def test_accuracy_total_is_the_jax_packages():
    """``Total`` is a device fill now, not a host copy: the same int32
    scalar as before and as the JAX package's, beside the same ``Correct``
    from the same weights."""
    (jm, js, _, _), (tm, _, _, _) = (mnist_momentum(jfluid, jmn),
                                     mnist_momentum(tfluid, tmn))
    jscope, tscope = from_jax(jm, js, tm)
    feed = mnist_feeds(1)[0]
    outs = []
    for fluid, main, scope in ((jfluid, jm, jscope), (tfluid, tm, tscope)):
        op = next(op for op in main.global_block.ops
                  if op.type == "accuracy")
        fetch = [op.output("Correct")[0], op.output("Total")[0]]
        with fluid.scope_guard(scope):
            outs.append(fluid.Executor(fluid.CPUPlace()).run(
                main, feed=feed, fetch_list=fetch, scope=scope,
                return_numpy=False))
    (jc, jt), (tc, tt) = outs
    assert tt.dtype == torch.int32 and tt.shape == () and int(tt) == 16
    assert str(np.asarray(jt).dtype) == "int32"
    assert (int(tt), int(tc)) == (int(np.asarray(jt)), int(np.asarray(jc)))


# -- against the JAX package --------------------------------------------------


def jax_run_steps(jm, jscope, feeds, fetch):
    with jfluid.scope_guard(jscope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        return exe.run_steps(jm, iter(feeds), steps=len(feeds),
                             fetch_list=fetch, fetch_every=4)


@pytest.mark.parametrize("model", ["bert_tiny", "mlp_momentum"])
def test_run_steps_matches_jax(model):
    if model == "bert_tiny":
        (jm, js, jloss), (tm, _, tloss) = (
            bert_pretrain(jfluid, jbert, dropout=0.0),
            bert_pretrain(tfluid, tbert, dropout=0.0))
        feeds = bert_feeds(8)
    else:
        (jm, js, jloss, _), (tm, _, tloss, _) = (
            mnist_momentum(jfluid, jmn), mnist_momentum(tfluid, tmn))
        feeds = mnist_feeds(8)
    jscope, tscope = from_jax(jm, js, tm)
    want = [float(r[0]) for r in jax_run_steps(jm, jscope, feeds, [jloss])]
    got = [float(r[0]) for r in tfluid.Executor(CPU).run_steps(
        tm, feeds, fetch_list=[tloss], fetch_every=4, scope=tscope)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.isfinite(got).all()


def test_deepfm_run_steps_matches_jax():
    set_flag("sparse_update_kernel", "off")
    try:
        (jm, js, jloss), (tm, _, tloss) = deepfm(jfluid, jdfm), \
            deepfm(tfluid, tdfm)
        feeds = deepfm_feeds(8)
        jscope, tscope = from_jax(jm, js, tm)
        want = [float(r[0]) for r in jax_run_steps(jm, jscope, feeds,
                                                   [jloss])]
    finally:
        set_flag("sparse_update_kernel", "auto")
    got = [float(r[0]) for r in tfluid.Executor(CPU).run_steps(
        tm, feeds, fetch_list=[tloss], fetch_every=4, scope=tscope)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for n in jscope.vars:
        np.testing.assert_allclose(tscope.as_numpy(n),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


def test_compiled_program_run_matches_jax():
    (jm, js, jloss, _), (tm, _, tloss, _) = (mnist_momentum(jfluid, jmn),
                                             mnist_momentum(tfluid, tmn))
    jscope, tscope = from_jax(jm, js, tm)
    feeds = mnist_feeds(4)
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jprog = jfluid.CompiledProgram(jm).with_data_parallel(
            loss_name=jloss.name)
        want = [float(jexe.run(jprog, feed=f, fetch_list=[jloss])[0])
                for f in feeds]
    texe = tfluid.Executor(CPU)
    tprog = tfluid.CompiledProgram(tm).with_data_parallel(
        loss_name=tloss.name)
    got = [float(texe.run(tprog, feed=f, fetch_list=[tloss],
                          scope=tscope)[0]) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=1e-5)
