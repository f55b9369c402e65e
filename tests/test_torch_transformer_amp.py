"""The port trains the Transformer under AMP as the JAX package does.

The 2-layer Transformer of ``test_torch_program.py`` (dropout 0, label
smoothing 0.1) is built by both packages with its Adam optimizer wrapped
in ``fluid.amp.decorate`` (bfloat16 forward and backward, float32 master
weights), as ``bench.py``'s ``bench_transformer`` runs it with
``use_amp=True``. From the JAX package's startup state (carried by
``io.state_from_numpy``), four Adam steps on one fixed batch: the losses
agree to 2e-2 relative (both round every activation to bfloat16, in
other orders), and the master weights stay float32.
"""

import numpy as np
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as jtfm
from paddle_tpu_torch.models import transformer as ttfm
from test_torch_program import SMALL
from test_torch_transformer_train import feed_batch


def build_amp_transformer(fluid, tfm, n_layer, d_model, n_head, d_inner,
                          seq, vocab, lr=1e-2):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = fluid.layers.data("src", shape=[seq], dtype="int64")
        trg = fluid.layers.data("trg", shape=[seq], dtype="int64")
        lbl = fluid.layers.data("lbl", shape=[seq, 1], dtype="int64")
        smask = fluid.layers.data("smask", shape=[seq], dtype="float32")
        tmask = fluid.layers.data("tmask", shape=[seq], dtype="float32")
        _, loss = tfm.transformer(
            src, trg, lbl, smask, tmask, src_vocab_size=vocab,
            trg_vocab_size=vocab, max_length=seq, n_layer=n_layer,
            n_head=n_head, d_model=d_model, d_inner=d_inner,
            dropout_rate=0.0, label_smooth_eps=0.1, is_test=False)
        fluid.amp.decorate(fluid.optimizer.Adam(learning_rate=lr)).minimize(
            loss)
    return main, startup, loss


def test_amp_losses_match_jax_over_4_adam_steps():
    feed = feed_batch()
    jm, js, jloss = build_amp_transformer(jfluid, jtfm, **SMALL)
    tm, _, tloss = build_amp_transformer(tfluid, ttfm, **SMALL)
    assert tm._amp_dtype == jm._amp_dtype == "bfloat16"
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
    got = [float(texe.run(tm, feed=feed, fetch_list=[tloss],
                          scope=tscope)[0]) for _ in range(4)]
    assert np.isfinite(got).all() and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=2e-2)
    params = tm.all_parameters()
    assert len(params) == 60
    assert all(tscope.find_var(p.name).dtype == torch.float32 for p in params)
