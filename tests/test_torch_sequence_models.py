"""The port trains the book's four sequence models as the JAX package does.

Each model is built by both packages at test size (equal op for op,
parameter for parameter), the JAX startup state is carried into the port
by ``io.state_from_numpy``, and both train 5 steps on one fixed batch on
the CPU under the model's recipe:

* ``stacked_lstm.stacked_lstm_net`` (3 stacked fc + ``dynamic_lstm``
  layers in alternating directions, max pools, softmax) under Adagrad;
* ``semantic_roles`` (``db_lstm`` at depth 3, the CRF cost) under SGD
  with ``exponential_decay``, and ``srl_decode`` on the ``for_test``
  clone;
* ``recommender`` (two towers, ``is_sparse`` tables, cosine similarity,
  square error) under SGD: the port's rows-only update (K4b's plain
  version here) against the JAX package's scatter path;
* ``machine_translation.seq_to_seq_net`` (GRU encoder, DynamicRNN
  attention decoder with ``gru_unit``) under Adam.

Losses to 1e-5 relative at every step, every persistable 1e-5 norm-wise
afterwards, the SRL decode paths identical. ``nets.sequence_conv_pool``
is held the same way. The port's eager steps and its captured steps
(``CompiledProgram``) are bit-equal on the CPU for the stacked LSTM and
the translation model.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.flags import set_flag

STEPS = 5
SRL_NAMES = ("word", "predicate", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1",
             "ctx_p2", "mark")
REC_NAMES = ("user_id", "gender_id", "age_id", "job_id", "movie_id",
             "category_id", "movie_title")


def _models(fluid):
    pkg = "paddle_tpu" if fluid is jfluid else "paddle_tpu_torch"
    import importlib

    return importlib.import_module(pkg + ".models")


def build_stacked_lstm(fluid, T=7, V=30):
    from_models = _models(fluid).stacked_lstm
    words = fluid.layers.data("words", shape=[T], dtype="int64")
    length = fluid.layers.data("length", shape=[], dtype="int64")
    label = fluid.layers.data("label", shape=[1], dtype="int64")
    loss, _ = from_models.stacked_lstm_net(words, length, label, dict_dim=V,
                                           emb_dim=8, hid_dim=16,
                                           stacked_num=3)
    fluid.optimizer.Adagrad(0.01).minimize(loss)
    return loss, None


def feed_stacked_lstm(rng, B=5, T=7, V=30):
    return {"words": rng.randint(0, V, (B, T)).astype("int64"),
            "length": np.array([7, 1, 3, 2, 5], "int64"),
            "label": rng.randint(0, 2, (B, 1)).astype("int64")}


def build_srl(fluid, T=6, L=5):
    srl = _models(fluid).semantic_roles
    feats = [fluid.layers.data(n, shape=[T], dtype="int64")
             for n in SRL_NAMES]
    target = fluid.layers.data("target", shape=[T], dtype="int64")
    length = fluid.layers.data("length", shape=[], dtype="int64")
    feature_out = srl.db_lstm(*feats, length=length, word_dict_len=20,
                              pred_dict_len=8, label_dict_len=L, word_dim=8,
                              hidden_dim=8, depth=3)
    cost = srl.srl_train_net(feature_out, target, length=length)
    main = fluid.default_main_program()
    test = main.clone(for_test=True)
    with fluid.program_guard(test):
        decode = srl.srl_decode(feature_out, length=length)
    lr = fluid.layers.exponential_decay(0.01, 100000, 0.5, staircase=True)
    fluid.optimizer.SGD(lr).minimize(cost)
    return cost, (test, decode)


def feed_srl(rng, B=4, T=6, L=5):
    feed = {n: rng.randint(0, 8 if n == "predicate" else 2 if n == "mark"
                           else 20, (B, T)).astype("int64")
            for n in SRL_NAMES}
    feed["target"] = rng.randint(0, L, (B, T)).astype("int64")
    feed["length"] = np.array([6, 1, 3, 4], "int64")
    return feed


def build_recommender(fluid):
    rec = _models(fluid).recommender
    ids = {n: fluid.layers.data(n, shape=[{"category_id": 3,
                                           "movie_title": 4}.get(n, 1)],
                                dtype="int64") for n in REC_NAMES}
    rating = fluid.layers.data("score", shape=[1], dtype="float32")
    usr = rec.usr_combined_features(ids["user_id"], ids["gender_id"],
                                    ids["age_id"], ids["job_id"],
                                    usr_dict_size=20, is_sparse=True)
    mov = rec.mov_combined_features(ids["movie_id"], ids["category_id"],
                                    ids["movie_title"], mov_dict_size=30,
                                    title_dict_size=50, is_sparse=True)
    _, cost = rec.inference_program(usr, mov, rating)
    fluid.optimizer.SGD(0.2).minimize(cost)
    return cost, None


def feed_recommender(rng, n=16):
    highs = {"user_id": 20, "gender_id": 2, "age_id": 7, "job_id": 21,
             "movie_id": 30, "category_id": 18, "movie_title": 50}
    widths = {"category_id": 3, "movie_title": 4}
    feed = {k: rng.randint(0, h, (n, widths.get(k, 1))).astype("int64")
            for k, h in highs.items()}
    feed["score"] = rng.randint(1, 6, (n, 1)).astype("float32")
    return feed


def build_nmt(fluid, TS=6, TT=5, V=20):
    mt = _models(fluid).machine_translation
    src = fluid.layers.data("src", shape=[TS], dtype="int64")
    src_len = fluid.layers.data("src_len", shape=[], dtype="int64")
    trg = fluid.layers.data("trg", shape=[TT], dtype="int64")
    trg_len = fluid.layers.data("trg_len", shape=[], dtype="int64")
    labels = fluid.layers.data("labels", shape=[TT, 1], dtype="int64")
    loss, _ = mt.seq_to_seq_net(src, src_len, trg, trg_len, labels, V,
                                embedding_dim=8, encoder_size=8,
                                decoder_size=8)
    fluid.optimizer.Adam(1e-3).minimize(loss)
    return loss, None


def feed_nmt(rng, B=4, TS=6, TT=5, V=20):
    feed = {"src": rng.randint(0, V, (B, TS)).astype("int64"),
            "src_len": np.array([6, 1, 3, 4], "int64"),
            "trg": rng.randint(0, V, (B, TT)).astype("int64"),
            "trg_len": np.array([5, 2, 1, 3], "int64")}
    feed["labels"] = np.roll(feed["trg"], -1, axis=1)[..., None]
    return feed


def build_conv_pool(fluid, T=6, D=4):
    x = fluid.layers.data("x", shape=[T, D])
    length = fluid.layers.data("length", shape=[], dtype="int64")
    label = fluid.layers.data("label", shape=[1], dtype="int64")
    pooled = fluid.nets.sequence_conv_pool(x, num_filters=6, filter_size=3,
                                           length=length)
    pred = fluid.layers.fc(pooled, size=3, act="softmax")
    loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
    fluid.optimizer.SGD(0.5).minimize(loss)
    return loss, None


def feed_conv_pool(rng, B=4, T=6, D=4):
    return {"x": rng.randn(B, T, D).astype("float32"),
            "length": np.array([6, 1, 3, 4], "int64"),
            "label": rng.randint(0, 3, (B, 1)).astype("int64")}


MODELS = {
    "stacked_lstm": (build_stacked_lstm, feed_stacked_lstm),
    "semantic_roles": (build_srl, feed_srl),
    "recommender": (build_recommender, feed_recommender),
    "machine_translation": (build_nmt, feed_nmt),
    "sequence_conv_pool": (build_conv_pool, feed_conv_pool),
}


def build(fluid, model):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, extra = MODELS[model][0](fluid)
    return main, startup, loss, extra


@pytest.fixture(autouse=True)
def _scatter_path():
    # the JAX package's CPU default for its rows-only updates
    set_flag("sparse_update_kernel", "off")
    yield
    set_flag("sparse_update_kernel", "auto")


_JAX_RUNS = {}


def jax_run(model):
    if model not in _JAX_RUNS:
        main, startup, loss, extra = build(jfluid, model)
        feed = MODELS[model][1](np.random.RandomState(0))
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(startup)
            start = {n: np.asarray(v) for n, v in scope.vars.items()}
            losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                      for _ in range(STEPS)]
            paths = None
            if extra is not None:
                paths = np.asarray(exe.run(extra[0], feed=feed,
                                           fetch_list=[extra[1]])[0])
            end = {n: np.asarray(v) for n, v in scope.vars.items()}
        _JAX_RUNS[model] = (main, start, feed, losses, end, paths)
    return _JAX_RUNS[model]


def norm_err(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_program_is_the_jax_packages(model):
    jmain = jax_run(model)[0]
    tmain = build(tfluid, model)[0]
    assert len(tmain.blocks) == len(jmain.blocks)
    for jb, tb in zip(jmain.blocks, tmain.blocks):
        assert [o.type for o in tb.ops] == [o.type for o in jb.ops]
    assert [(p.name, tuple(p.shape)) for p in tmain.all_parameters()] == \
        [(p.name, tuple(p.shape)) for p in jmain.all_parameters()]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_trains_as_the_jax_package(model):
    _, start, feed, want, end, paths = jax_run(model)
    main, _, loss, extra = build(tfluid, model)
    scope = tfluid.io.state_from_numpy(main, start, tfluid.Scope(),
                                       tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    got = [float(exe.run(main, feed=feed, fetch_list=[loss],
                         scope=scope)[0]) for _ in range(STEPS)]
    assert np.isfinite(got).all() and got[-1] < got[0], got
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for n, w in end.items():
        g = scope.as_numpy(n)
        if np.issubdtype(w.dtype, np.floating):
            assert norm_err(g, w) <= 1e-5, (n, norm_err(g, w))
        else:
            np.testing.assert_array_equal(g, w, err_msg=n)
    if extra is not None:
        decoded = exe.run(extra[0], feed=feed, fetch_list=[extra[1]],
                          scope=scope)[0]
        np.testing.assert_array_equal(decoded, paths)
        lengths = feed["length"]
        assert decoded.min() >= 0 and decoded.max() < 5
        for b, n in enumerate(lengths):
            assert not decoded[b, n:].any()


@pytest.mark.parametrize("model", ["stacked_lstm", "machine_translation"])
def test_captured_steps_equal_eager_steps_bit_for_bit(model):
    main, startup, loss, _ = build(tfluid, model)
    feed = MODELS[model][1](np.random.RandomState(0))
    init = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=init)
    arrays = {n: init.as_numpy(n) for n in init.vars}

    def scope():
        return tfluid.io.state_from_numpy(main, arrays, tfluid.Scope(),
                                          tfluid.CPUPlace())

    s_e, s_c = scope(), scope()
    eager = [float(exe.run(main, feed=feed, fetch_list=[loss],
                           scope=s_e)[0]) for _ in range(4)]
    main._tpu_step_counter = 0
    rows = exe.run_steps(main, [feed] * 4, fetch_list=[loss], scope=s_c)
    assert [float(r[0]) for r in rows] == eager
    for n in arrays:
        np.testing.assert_array_equal(s_c.as_numpy(n), s_e.as_numpy(n))
