"""The Transformer under ``dist_transformer.py``'s loss trains in the port
as in the JAX package.

Fluid's ``dist_transformer.py`` (and PaddlePaddle/models' NMT
``transformer/model.py``) write the loss from primitives:
``label_smooth(one_hot(label), 0.1)``, a soft-label
``softmax_with_cross_entropy``, then ``reduce_sum(cost * weights) /
reduce_sum(weights)``. The port builds it with
``models.transformer.transformer(..., one_hot_loss=True)``; the JAX
package's side writes the same ops after its ``transformer``'s logits.
At 2 layers, d_model 32, from the JAX startup state (carried by
``io.state_from_numpy``), 3 Adam steps on one fixed batch with padding:

* float32: losses to 1e-5 relative, state to 1e-4 norm-wise;
* under ``amp.decorate`` (bfloat16): losses to 2e-2;
* on the CPU the one-hot form equals the fused form (smoothing inside
  ``softmax_with_cross_entropy``) at dropout 0: losses to 1e-6, and one
  step's state to 1e-6 norm-wise.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as jtfm
from paddle_tpu_torch.models import transformer as ttfm

SMALL = dict(n_layer=2, d_model=32, n_head=2, d_inner=64, seq=16, vocab=64)
B = 4
EPS = 0.1


def feed_batch(seed=0):
    """A fixed batch whose last rows are padded (weights 0 past a
    length)."""
    rng = np.random.RandomState(seed)
    s, v = SMALL["seq"], SMALL["vocab"]
    lens = np.array([s, s - 3, s - 7, 5])
    pad = (np.arange(s)[None, :] < lens[:, None]).astype("float32")
    return {
        "src": rng.randint(2, v, (B, s)).astype("int64"),
        "trg": rng.randint(2, v, (B, s)).astype("int64"),
        "lbl": rng.randint(2, v, (B, s, 1)).astype("int64"),
        "smask": np.ones((B, s), "float32"),
        "tmask": pad,
    }


def dist_loss(fluid, logits, lbl, tmask, vocab):
    """``dist_transformer.py``'s loss on [B, S, V] logits."""
    layers = fluid.layers
    label = layers.label_smooth(layers.one_hot(lbl, depth=vocab),
                                epsilon=EPS)
    cost = layers.softmax_with_cross_entropy(logits, label, soft_label=True)
    weights = layers.unsqueeze(tmask, axes=[2])
    return layers.elementwise_div(
        layers.reduce_sum(layers.elementwise_mul(cost, weights)),
        layers.reduce_sum(weights))


def build(fluid, one_hot, amp=False, dropout=0.0, lr=1e-2):
    """(main, startup, loss): the 2-layer Transformer with the
    ``dist_transformer.py`` loss (``one_hot``) or the fused one. The JAX
    package has no ``one_hot_loss``: its loss is written after the
    logits."""
    cfg = dict(SMALL)
    seq, vocab = cfg.pop("seq"), cfg.pop("vocab")
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = fluid.layers.data("src", shape=[seq], dtype="int64")
        trg = fluid.layers.data("trg", shape=[seq], dtype="int64")
        lbl = fluid.layers.data("lbl", shape=[seq, 1], dtype="int64")
        smask = fluid.layers.data("smask", shape=[seq], dtype="float32")
        tmask = fluid.layers.data("tmask", shape=[seq], dtype="float32")
        kw = dict(src_vocab_size=vocab, trg_vocab_size=vocab,
                  max_length=seq, dropout_rate=dropout,
                  label_smooth_eps=EPS, is_test=False, **cfg)
        if fluid is tfluid:
            logits, loss = ttfm.transformer(src, trg, lbl, smask, tmask,
                                            one_hot_loss=one_hot, **kw)
        else:
            logits, loss = jtfm.transformer(src, trg, lbl, smask, tmask,
                                            **kw)
            if one_hot:
                loss = dist_loss(fluid, logits, lbl, tmask, vocab)
        opt = fluid.optimizer.Adam(learning_rate=lr)
        if amp:
            opt = fluid.amp.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def jax_start(amp=False):
    jm, js, jloss = build(jfluid, True, amp=amp)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(js)
    return jm, jloss, scope


def port_run(one_hot, arrays, feed, steps, amp=False, dropout=0.0):
    tm, _, tloss = build(tfluid, one_hot, amp=amp, dropout=dropout)
    scope = tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(),
                                       tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses = [float(exe.run(tm, feed=feed, fetch_list=[tloss],
                            scope=scope)[0]) for _ in range(steps)]
    return tm, losses, scope


def state_err(tm, scope, arrays):
    d2 = n2 = 0.0
    for p in tm.all_parameters():
        got = np.asarray(scope.find_var(p.name), np.float64)
        want = np.asarray(arrays[p.name], np.float64)
        d2 += float(np.sum((got - want) ** 2))
        n2 += float(np.sum(want ** 2))
    return (d2 / n2) ** 0.5


def test_port_builds_the_dist_transformer_ops():
    tm, _, _ = build(tfluid, True)
    types = [op.type for op in tm.global_block.ops]
    assert types.count("one_hot") == 1 and types.count("label_smooth") == 1
    xent = [op for op in tm.global_block.ops
            if op.type == "softmax_with_cross_entropy"]
    assert len(xent) == 1 and xent[0].attrs["soft_label"] is True
    fused, _, _ = build(tfluid, False)
    assert "one_hot" not in [op.type for op in fused.global_block.ops]


@pytest.mark.parametrize("amp", (False, True), ids=("float32", "amp"))
def test_losses_match_jax_over_3_adam_steps(amp):
    feed = feed_batch()
    jm, jloss, jscope = jax_start(amp)
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
    with jfluid.scope_guard(jscope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        want = [float(exe.run(jm, feed=feed, fetch_list=[jloss])[0])
                for _ in range(3)]
        after = {p.name: np.asarray(jscope.find_var(p.name))
                 for p in jm.all_parameters()}
    tm, got, scope = port_run(True, arrays, feed, 3, amp=amp)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-2 if amp else 1e-5)
    if not amp:
        assert state_err(tm, scope, after) <= 1e-4


def test_one_hot_form_equals_fused_form_at_dropout_0():
    feed = feed_batch(1)
    _, _, jscope = jax_start()
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
    tm, one_hot, s1 = port_run(True, arrays, feed, 2)
    fm, fused, s2 = port_run(False, arrays, feed, 2)
    np.testing.assert_allclose(one_hot, fused, rtol=1e-6)
    after = {p.name: np.asarray(s2.find_var(p.name))
             for p in fm.all_parameters()}
    assert state_err(tm, s1, after) <= 1e-6


def test_one_hot_form_trains_with_dropout():
    feed = feed_batch(2)
    _, _, jscope = jax_start()
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
    _, losses, _ = port_run(True, arrays, feed, 6, dropout=0.1)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
