"""The port builds and trains BERT as the JAX package does.

* ``models.bert``'s named configs are the JAX package's;
* BERT-base pretraining as ``bench.py``'s ``bench_bert`` builds it
  (batch of 128 tokens, 20 masked positions, dropout 0.1, Adam) has the
  same ops, attrs, parameter names and shapes in both packages (built,
  not run): 443 ops of 20 types, 135 parameters, 133,510,460 weights;
* ``bert_tiny`` pretraining, dropout 0, from the JAX package's startup
  state (carried by ``io.state_from_numpy``), 4 Adam(1e-3) steps on one
  batch whose masked positions repeat one: float32 losses to 1e-5
  relative and parameters to 1e-5 absolute; under ``amp.decorate``
  (bfloat16) the losses to 2e-2 relative, and the segment mask
  ``cast(input_mask, "int32")`` stays an int32 tensor.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.models import bert as tbert

B, S, N_MASK = 4, 16, 3


def build_pretrain(fluid, bert, cfg, seq=S, n_mask=N_MASK, dropout=0.0,
                   amp=False, lr=1e-3):
    """``bench.py``'s ``bench_bert`` program for either package; returns
    (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[seq], dtype="int64")
        pos = fluid.layers.data("pos", shape=[seq], dtype="int64")
        sent = fluid.layers.data("sent", shape=[seq], dtype="int64")
        mask = fluid.layers.data("mask", shape=[seq], dtype="float32")
        mpos = fluid.layers.data("mpos", shape=[n_mask], dtype="int64")
        mlbl = fluid.layers.data("mlbl", shape=[1], dtype="int64")
        nsp = fluid.layers.data("nsp", shape=[1], dtype="int64")
        loss, _, _ = bert.bert_pretrain(ids, pos, sent, mask, mpos, mlbl,
                                        nsp, dropout_rate=dropout, **cfg)
        opt = fluid.optimizer.Adam(learning_rate=lr)
        if amp:
            opt = fluid.amp.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def pretrain_feed(vocab, seed=0):
    """The bench's feed at test size, with a padded mask and segment ids;
    masked positions are flat indices into [B*S], and row 0 masks one
    position twice."""
    rng = np.random.RandomState(seed)
    feed = {
        "ids": rng.randint(0, vocab, (B, S)).astype("int64"),
        "pos": np.tile(np.arange(S), (B, 1)).astype("int64"),
        "sent": rng.randint(0, 2, (B, S)).astype("int64"),
        "mask": (rng.rand(B, S) > 0.2).astype("float32"),
        "mpos": (np.arange(B)[:, None] * S
                 + rng.randint(0, S, (B, N_MASK))).astype("int64"),
        "mlbl": rng.randint(0, vocab, (B * N_MASK, 1)).astype("int64"),
        "nsp": rng.randint(0, 2, (B, 1)).astype("int64"),
    }
    feed["mpos"][0, 1] = feed["mpos"][0, 0]
    return feed


def ops_of(program):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in program.global_block.ops]


@pytest.mark.parametrize("name", ["BERT_BASE_CONFIG", "BERT_LARGE_CONFIG",
                                  "BERT_TINY_CONFIG"])
def test_named_configs_match(name):
    assert getattr(tbert, name) == getattr(jbert, name)


def test_bert_base_pretrain_program_matches():
    jm, _, jloss = build_pretrain(jfluid, jbert, jbert.BERT_BASE_CONFIG,
                                  seq=128, n_mask=20, dropout=0.1, lr=1e-4)
    tm, _, tloss = build_pretrain(tfluid, tbert, tbert.BERT_BASE_CONFIG,
                                  seq=128, n_mask=20, dropout=0.1, lr=1e-4)
    assert tloss.name == jloss.name
    assert ops_of(tm) == ops_of(jm)
    shapes = {p.name: p.shape for p in tm.all_parameters()}
    assert shapes == {p.name: p.shape for p in jm.all_parameters()}
    types = [op.type for op in tm.global_block.ops]
    assert (len(types), len(set(types)), len(shapes)) == (443, 20, 135)
    assert sum(int(np.prod(s)) for s in shapes.values()) == 133_510_460


@pytest.mark.parametrize("fn", ["bert_base", "bert_large", "bert_tiny"])
def test_named_encoders_build_the_same_parameters(fn):
    def params(fluid, bert):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            args = [fluid.layers.data(n, shape=[8], dtype="int64")
                    for n in ("ids", "pos", "sent")]
            mask = fluid.layers.data("mask", shape=[8], dtype="float32")
            seq_out, pooled = getattr(bert, fn)(*args, mask, is_test=True)
        return ({p.name: p.shape for p in main.all_parameters()},
                seq_out.shape, pooled.shape)

    assert params(tfluid, tbert) == params(jfluid, jbert)


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "bf16_amp"])
def test_bert_tiny_pretraining_matches_jax(amp):
    cfg = tbert.BERT_TINY_CONFIG
    feed = pretrain_feed(cfg["vocab_size"])
    jm, js, jloss = build_pretrain(jfluid, jbert, cfg, amp=amp)
    tm, _, tloss = build_pretrain(tfluid, tbert, cfg, amp=amp)
    assert ops_of(tm) == ops_of(jm)
    seg = next(op.output("Out")[0] for op in tm.global_block.ops
               if op.type == "cast" and op.input("X") == ["mask"])
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
        want = [float(jexe.run(jm, feed=feed, fetch_list=[jloss])[0])
                for _ in range(4)]
    tscope = tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(),
                                        tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    got, segs = [], []
    for _ in range(4):
        lv, sv = texe.run(tm, feed=feed, fetch_list=[tloss, seg],
                          scope=tscope, return_numpy=False)
        got.append(float(lv))
        segs.append(sv)
    assert all(s.dtype == torch.int32 for s in segs)
    np.testing.assert_array_equal(segs[0].numpy(), feed["mask"])
    assert np.isfinite(got).all() and got[-1] < got[0]
    if amp:
        np.testing.assert_allclose(got, want, rtol=2e-2)
        return
    np.testing.assert_allclose(got, want, rtol=1e-5)
    params = [p.name for p in tm.all_parameters()]
    assert len(params) == 35
    for n in params:
        np.testing.assert_allclose(tscope.as_numpy(n),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=0, atol=1e-5, err_msg=n)
