"""The port trains the book's word2vec N-gram model as the JAX package does.

``models.word2vec.word2vec_ngram`` built by both packages (equal op for op
and var for var) at the book's embedding and hidden widths (32, 256) over
a dictionary of V = 30: four dense lookups of the one shared table
``shared_w``, ``concat``, ``fc(act="sigmoid")``, ``fc(act="softmax")`` and
``cross_entropy``. Synthetic 5-grams whose fifth word is (w0 + w1) mod V
(``tests/test_models.py``), batch 100, ``SGD(0.1)``, 5 steps from the JAX
startup state carried by ``io.state_from_numpy``, on the CPU.

At ``PADDLE_TPU_OPT_LEVEL`` 1 (the default) both packages'
``softmax_xent_fuse_pass`` turns the softmax and the cross-entropy into
``softmax_with_cross_entropy``, which the port runs through K2's wrapper
(its plain version here, K2a/K2b on the card); at level 0 the program
runs as built. Losses to 1e-6 relative against the JAX package at level 1
and against the port at level 0, every persistable 1e-6 norm-wise.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import word2vec as jw2v
from paddle_tpu_torch.models import word2vec as tw2v
from paddle_tpu_torch.passes.pipeline import optimize_program

V, BATCH, STEPS = 30, 100, 5
WORDS = ("firstw", "secondw", "thirdw", "forthw", "nextw")


def build(fluid, w2v):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        words = [fluid.layers.data(n, shape=[1], dtype="int64")
                 for n in WORDS]
        loss, _ = w2v.word2vec_ngram(*words, dict_size=V, embed_size=32,
                                     hidden_size=256)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def ngram_feed(seed=0):
    rng = np.random.RandomState(seed)
    ctx = rng.randint(0, V, (BATCH, 4)).astype("int64")
    nxt = ((ctx[:, 0] + ctx[:, 1]) % V).reshape(-1, 1).astype("int64")
    feed = {n: ctx[:, j:j + 1] for j, n in enumerate(WORDS[:4])}
    feed["nextw"] = nxt
    return feed


def train_port(main, loss, arrays, feed):
    scope = tfluid.io.state_from_numpy(main, arrays, tfluid.Scope(),
                                       tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(STEPS)]
    return losses, scope


@pytest.fixture(scope="module")
def jax_run():
    main, startup, loss = build(jfluid, jw2v)
    feed = ngram_feed()
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        start = {n: np.asarray(v) for n, v in scope.vars.items()}
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                  for _ in range(STEPS)]
    end = {n: np.asarray(v) for n, v in scope.vars.items()}
    return main, start, losses, end, feed


def norm_err(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("level", [1, 0])
def test_word2vec_trains_as_jax_does(jax_run, level, monkeypatch):
    jm, start, want, end, feed = jax_run
    monkeypatch.setenv("PADDLE_TPU_OPT_LEVEL", str(level))
    main, _, loss = build(tfluid, tw2v)
    assert [op.type for op in main.global_block.ops] == \
        [op.type for op in jm.global_block.ops]
    assert [(v.name, v.shape) for v in main.list_vars()] == \
        [(v.name, v.shape) for v in jm.list_vars()]
    assert [op.type for op in main.global_block.ops].count(
        "lookup_table") == 4
    got, scope = train_port(main, loss, start, feed)
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for n in start:
        assert norm_err(scope.as_numpy(n), end[n]) <= 1e-6, n


@pytest.mark.parametrize("level", [1, 0])
def test_fuse_pass_reaches_k2_at_level_one_only(level):
    main, _, loss = build(tfluid, tw2v)
    ops = [op.type for op in optimize_program(
        main, (loss.name,), level=level).global_block.ops]
    fwd = ops[:ops.index("backward_marker")]
    if level:
        assert fwd.count("softmax_with_cross_entropy") == 1
        assert "softmax" not in fwd and "cross_entropy" not in fwd
    else:
        assert "softmax_with_cross_entropy" not in fwd
        assert fwd.count("softmax") == 1 and fwd.count("cross_entropy") == 1
