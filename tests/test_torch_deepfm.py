"""The port trains DeepFM as the JAX package does.

DeepFM at test size (V = 1000, 8 fields, embedding 4, deep layers
(16, 16), batch 32) is built by both packages with ``is_sparse=True``
tables; the JAX startup program initialises the weights, which
``io.state_from_numpy`` carries into the port's scope (torch cannot redraw
threefry). Four steps of Adam, and of SGD, on one fixed batch through each
``Executor.run``, the JAX package on its scatter path
(``FLAGS_sparse_update_kernel=off``, its CPU default):

* the losses agree to 1e-5 relative (float32, another summation order);
* every persistable (tables, moments, beta pows, fc weights, the AUC
  histograms) agrees to rtol 1e-4 and atol 1e-6, the tolerance of the JAX
  package's own kernel-vs-scatter test (``tests/test_sparse_kernel.py``).

The port merges duplicate ids before the SGD update (the kernel's input),
where the JAX scatter path adds them one by one: the same sum in another
order. Also held: the ``padding_idx`` row, masked ids < 0 (row 0 stays
bit-equal), both errors of the sparse path, and a sparse SGD step equal to
the dense ``is_sparse=False`` one.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.flags import set_flag
from paddle_tpu.models import deepfm as jdfm
from paddle_tpu_torch.models import deepfm as tdfm

V, FIELDS, EMB, LAYERS, B = 1000, 8, 4, (16, 16), 32


@pytest.fixture(autouse=True)
def _scatter_path():
    set_flag("sparse_update_kernel", "off")
    yield
    set_flag("sparse_update_kernel", "auto")


def optimizer(fluid, opt):
    return fluid.optimizer.Adam(1e-3) if opt == "adam" \
        else fluid.optimizer.SGD(1e-2)


def build_deepfm(fluid, dfm, opt, is_sparse=True):
    """``bench.py``'s ``bench_deepfm`` program at test size."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[FIELDS], dtype="int64")
        dense = fluid.layers.data("dense", shape=[13])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        _, loss, auc = dfm.deepfm(ids, dense, label, sparse_feature_dim=V,
                                  embedding_size=EMB, num_fields=FIELDS,
                                  layer_sizes=LAYERS, is_sparse=is_sparse)
        optimizer(fluid, opt).minimize(loss)
    return main, startup, loss, auc


def deepfm_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, V, (B, FIELDS)).astype("int64"),
            "dense": rng.rand(B, 13).astype("float32"),
            "label": rng.randint(0, 2, (B, 1)).astype("int64")}


def train_both(jprog, tprog, feed, steps=4):
    """``steps`` runs of each package from the JAX startup's weights;
    returns (JAX fetches, port fetches, JAX scope, port scope)."""
    (jm, js, jfetch), (tm, tfetch) = jprog, tprog
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
        want = [jexe.run(jm, feed=feed, fetch_list=jfetch)
                for _ in range(steps)]
    tscope = tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(),
                                        tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = [texe.run(tm, feed=feed, fetch_list=tfetch, scope=tscope)
           for _ in range(steps)]
    return want, got, jscope, tscope


def assert_state_matches(tprog, jscope, tscope):
    names = sorted(v.name for v in tprog.list_vars() if v.persistable)
    for n in names:
        np.testing.assert_allclose(tscope.as_numpy(n),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=1e-4, atol=1e-6, err_msg=n)
    return names


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_deepfm_matches_jax_over_4_steps(opt):
    jm, js, jloss, jauc = build_deepfm(jfluid, jdfm, opt)
    tm, _, tloss, tauc = build_deepfm(tfluid, tdfm, opt)
    assert [op.type for op in tm.global_block.ops] == \
        [op.type for op in jm.global_block.ops]
    want, got, jscope, tscope = train_both((jm, js, [jloss, jauc]),
                                           (tm, [tloss, tauc]),
                                           deepfm_feed())
    np.testing.assert_allclose([float(g[0]) for g in got],
                               [float(w[0]) for w in want], rtol=1e-5)
    np.testing.assert_allclose([float(g[1]) for g in got],
                               [float(w[1]) for w in want], rtol=1e-6)
    losses = [float(g[0]) for g in got]
    assert losses[-1] < losses[0]
    names = assert_state_matches(tm, jscope, tscope)
    assert {"sparse_emb", "sparse_w1", "auc_stat_pos_0",
            "auc_stat_neg_0"} <= set(names)
    if opt == "adam":
        assert {"sparse_emb_adam_moment1_0",
                "sparse_w1_adam_moment2_0"} <= set(names)
    assert tscope.as_numpy("auc_stat_pos_0").sum() \
        + tscope.as_numpy("auc_stat_neg_0").sum() == 4 * B


def build_embedding(fluid, vocab, dim, opt, padding_idx=None,
                    is_sparse=True, lookups=1):
    """``tests/test_sparse_kernel.py``'s program: an embedding of 4 ids a
    row into a two-class head."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[4], dtype="int64")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        embs = [fluid.layers.embedding(
            ids, size=[vocab, dim], is_sparse=is_sparse,
            padding_idx=padding_idx, param_attr=fluid.ParamAttr(name="table"))
            for _ in range(lookups)]
        flat = fluid.layers.reshape(embs[-1], [-1, 4 * dim])
        logits = fluid.layers.fc(flat, size=2)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        optimizer(fluid, opt).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_padding_idx_row_matches_jax(opt):
    """The ``padding_idx`` row keeps its id and gets a zero gradient row:
    under Adam its moments stay 0 (they decay lazily from 0), as in the JAX
    package."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 200, (24, 4)).astype("int64")
    ids[:6] = ids[6:12]
    ids[0, 0] = 3
    feed = {"ids": ids, "label": (ids[:, :1] % 2).astype("int64")}
    jm, js, jloss = build_embedding(jfluid, 200, 10, opt, padding_idx=3)
    tm, _, tloss = build_embedding(tfluid, 200, 10, opt, padding_idx=3)
    want, got, jscope, tscope = train_both((jm, js, [jloss]),
                                           (tm, [tloss]), feed)
    np.testing.assert_allclose([float(g[0]) for g in got],
                               [float(w[0]) for w in want], rtol=1e-5)
    assert_state_matches(tm, jscope, tscope)
    if opt == "adam":
        m1 = tscope.as_numpy("table_adam_moment1_0")
        np.testing.assert_array_equal(m1[3], 0.0)  # zero gradient rows
        assert tscope.as_numpy("table_adam_moment2_0")[3].sum() == 0.0


def test_masked_negative_ids_never_touch_row0():
    """ids < 0 give zero rows and map to the padding id V, so no update
    reads or writes row 0 for them: it stays bit-equal in the table and
    both moments, and the run matches the JAX package's."""
    rng = np.random.RandomState(1)
    ids = rng.randint(1, 50, (16, 4)).astype("int64")
    ids[:, 0] = -1
    feed = {"ids": ids, "label": (ids[:, 1:2] % 2).astype("int64")}
    jm, js, jloss = build_embedding(jfluid, 50, 10, "adam")
    tm, _, tloss = build_embedding(tfluid, 50, 10, "adam")
    want, got, jscope, tscope = train_both((jm, js, [jloss]),
                                           (tm, [tloss]), feed, steps=3)
    np.testing.assert_allclose([float(g[0]) for g in got],
                               [float(w[0]) for w in want], rtol=1e-5)
    for n in ("table", "table_adam_moment1_0", "table_adam_moment2_0"):
        np.testing.assert_array_equal(tscope.as_numpy(n)[0],
                                      np.asarray(jscope.find_var(n))[0])
    np.testing.assert_array_equal(tscope.as_numpy("table_adam_moment1_0")[0],
                                  0.0)
    assert_state_matches(tm, jscope, tscope)


def port_run(prog, feed, steps=1, arrays=None):
    main, startup, loss = prog
    exe = tfluid.Executor(tfluid.CPUPlace())
    if arrays is None:
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
    else:
        scope = tfluid.io.state_from_numpy(main, arrays, tfluid.Scope(),
                                           tfluid.CPUPlace())
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    return losses, scope


def test_sparse_table_looked_up_twice_raises():
    prog = build_embedding(tfluid, 50, 4, "sgd", lookups=2)
    feed = {"ids": np.ones((8, 4), "int64"), "label": np.ones((8, 1), "int64")}
    with pytest.raises(NotImplementedError, match="more than once"):
        port_run(prog, feed)


def test_sparse_param_never_looked_up_sparsely_raises():
    main, startup, loss = build_embedding(tfluid, 50, 4, "sgd",
                                          is_sparse=False)
    main.global_block.var("table").is_sparse_param = True
    feed = {"ids": np.ones((8, 4), "int64"), "label": np.ones((8, 1), "int64")}
    with pytest.raises(ValueError, match="never looked up"):
        port_run((main, startup, loss), feed)


def test_sparse_sgd_step_equals_dense_sgd_step():
    """Row-wise SGD on merged duplicate ids moves the table as the dense
    gradient's SGD does (the twin of ``tests/test_sparse.py``'s test)."""
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 300, (32, 4)).astype("int64")
    ids[:8] = ids[8:16]
    feed = {"ids": ids, "label": (ids[:, :1] % 2).astype("int64")}
    dense = build_embedding(tfluid, 300, 16, "sgd", is_sparse=False)
    sparse = build_embedding(tfluid, 300, 16, "sgd")
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(dense[1], scope=scope)
    arrays = {n: scope.as_numpy(n) for n in scope.vars}
    l_dense, s_dense = port_run(dense, feed, 4, arrays)
    l_sparse, s_sparse = port_run(sparse, feed, 4, arrays)
    np.testing.assert_allclose(l_sparse, l_dense, rtol=1e-5)
    for n in arrays:
        np.testing.assert_allclose(s_sparse.as_numpy(n), s_dense.as_numpy(n),
                                   rtol=2e-5, atol=1e-6, err_msg=n)
    assert not np.array_equal(s_sparse.as_numpy("table"), arrays["table"])


def test_sparse_tables_refuse_clipping_regularization_and_sharding():
    """No SparseGrad may reach the ops of ``clip.py`` or ``regularizer.py``:
    building such a program raises; ``sharding_axis`` waits for the port
    of ``parallel/``."""
    for kw in ({"regularization": tfluid.regularizer.L2Decay(1e-4)},
               {"grad_clip": tfluid.clip.GradientClipByValue(1.0)}):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
            ids = tfluid.layers.data("ids", shape=[4], dtype="int64")
            emb = tfluid.layers.embedding(ids, size=[50, 4], is_sparse=True)
            loss = tfluid.layers.mean(emb)
            if "grad_clip" in kw:
                tfluid.clip.set_gradient_clip(kw["grad_clip"])
                kw = {}
            with pytest.raises(NotImplementedError, match="is_sparse"):
                tfluid.optimizer.SGD(1e-2, **kw).minimize(loss)
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        ids = tfluid.layers.data("ids", shape=[4], dtype="int64")
        with pytest.raises(NotImplementedError, match="parallel"):
            tdfm.deepfm(ids, None, None, num_fields=4, sharding_axis="model")


def test_sparse_tables_train_under_amp_as_jax_does():
    """Under ``amp.decorate`` the lookup's virtual rows leaf takes the AMP
    dtype (bfloat16), as in the JAX package, while the tables and their
    moments stay float32; the losses follow the JAX package's to 2e-2
    (bfloat16 rounding, as in ``test_torch_causal_lm.py``)."""
    progs = []
    for fluid, dfm in ((jfluid, jdfm), (tfluid, tdfm)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            ids = fluid.layers.data("ids", shape=[FIELDS], dtype="int64")
            dense = fluid.layers.data("dense", shape=[13])
            label = fluid.layers.data("label", shape=[1], dtype="int64")
            _, loss, _ = dfm.deepfm(ids, dense, label, sparse_feature_dim=V,
                                    embedding_size=EMB, num_fields=FIELDS,
                                    layer_sizes=LAYERS)
            fluid.amp.decorate(fluid.optimizer.Adam(1e-2)).minimize(loss)
        progs.append((main, startup, loss))
    (jm, js, jloss), (tm, _, tloss) = progs
    want, got, _, tscope = train_both((jm, js, [jloss]), (tm, [tloss]),
                                      deepfm_feed())
    losses = [float(g[0]) for g in got]
    np.testing.assert_allclose(losses, [float(w[0]) for w in want],
                               rtol=2e-2)
    assert losses[-1] < losses[0]
    for n in ("sparse_emb", "sparse_emb_adam_moment1_0", "sparse_w1"):
        assert tscope.as_numpy(n).dtype == np.float32
