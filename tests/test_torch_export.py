"""``inference.export_program`` / ``load_program``, the port's counterpart
of the JAX package's ``export_stablehlo`` / ``load_stablehlo``: a BERT
inference program (``bert_tiny``, ``is_test``) exported once with a
symbolic batch runs at two batch sizes equal to ``Executor.run`` of the
same program and scope (1e-6), with the meta JSON beside the
``__program__.pt2`` artifact; with ``batch_polymorphic=False`` it runs
at the example's shape only. On the CPU a step that reaches a kernel's
wrapper takes its plain version and exports (the causal LM on the flash
route); on the card such an export raises ``ExportRefused`` naming the
kernel (``cuda``-marked, skipped here), and ``_build.refuse_export``
raises only inside ``_build.exporting()``.

The file imports neither ``jax`` nor ``paddle_tpu``: the JAX package's
artifact is StableHLO, which the port does not read."""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import inference
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.models import transformer as tfm
from paddle_tpu_torch.ops.kernels import _build

S = 16
FEEDS = ["ids", "pos", "sent", "mask"]


def build_bert(place):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[S], dtype="int64")
        pos = fluid.layers.data("pos", shape=[S], dtype="int64")
        sent = fluid.layers.data("sent", shape=[S], dtype="int64")
        mask = fluid.layers.data("mask", shape=[S], dtype="float32")
        seq, pooled = bert.bert_tiny(ids, pos, sent, mask, dropout_rate=0.0,
                                     is_test=True)
    scope, exe = fluid.Scope(), fluid.Executor(place)
    exe.run(startup, scope=scope)
    return main, scope, exe, [pooled, seq]


def feed(batch, seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((batch, S), "float32")
    mask[:, S - 3:] = 0.0
    return {"ids": rng.randint(0, 100, (batch, S)).astype("int64"),
            "pos": np.tile(np.arange(S), (batch, 1)).astype("int64"),
            "sent": rng.randint(0, 2, (batch, S)).astype("int64"),
            "mask": mask}


def test_one_artifact_runs_at_two_batch_sizes(tmp_path):
    main, scope, exe, fetch = build_bert(fluid.CPUPlace())
    d = str(tmp_path / "bert")
    path = inference.export_program(d, FEEDS, fetch, feed(4), program=main,
                                    scope=scope)
    assert path == os.path.join(d, "__program__.pt2") and os.path.exists(path)
    with open(os.path.join(d, "__program_meta__.json")) as f:
        assert json.load(f) == {"feed_names": FEEDS,
                                "fetch_names": [v.name for v in fetch]}
    loaded = inference.load_program(d)
    test = main.clone(for_test=True)
    for batch in (3, 9):
        got = loaded.run(feed(batch, seed=batch))
        want = exe.run(test, feed=feed(batch, seed=batch), fetch_list=fetch,
                       scope=scope)
        assert [g.shape for g in got] == [w.shape for w in want]
        assert got[0].shape[0] == batch
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_a_fixed_batch_artifact(tmp_path):
    main, scope, exe, fetch = build_bert(fluid.CPUPlace())
    d = str(tmp_path / "fixed")
    inference.export_program(d, FEEDS, fetch[:1], feed(4), program=main,
                             scope=scope, batch_polymorphic=False)
    loaded = inference.load_program(d)
    want = exe.run(main.clone(for_test=True), feed=feed(4, 1),
                   fetch_list=fetch[:1], scope=scope)[0]
    np.testing.assert_allclose(loaded.run(feed(4, 1))[0], want, rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(Exception):
        loaded.run(feed(5))


def build_lm(seq=256):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[seq], dtype="int64")
        lbl = fluid.layers.data("lbl", shape=[seq, 1], dtype="int64")
        # head width 32: one the flash kernels are built for
        logits, _ = tfm.causal_lm(ids, lbl, vocab_size=64, max_length=seq,
                                  n_layer=1, n_head=2, d_model=64,
                                  d_inner=64, dropout_rate=0.0, is_test=True)
    return main, startup, logits


@pytest.fixture
def flash_route():
    old = fluid.get_flag("flash_attention_min_seq")
    fluid.set_flag("flash_attention_min_seq", 128)
    yield
    fluid.set_flag("flash_attention_min_seq", old)


def test_on_the_cpu_a_kernel_path_exports_its_plain_version(
        tmp_path, flash_route, monkeypatch):
    from paddle_tpu_torch.ops import attention_ops

    routes = []
    gate = attention_ops._flash_ok
    monkeypatch.setattr(attention_ops, "_flash_ok",
                        lambda *a: routes.append(gate(*a)) or routes[-1])
    main, startup, logits = build_lm()
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    ids = np.random.RandomState(2).randint(0, 64, (2, 256)).astype("int64")
    d = str(tmp_path / "lm")
    inference.export_program(d, ["ids"], [logits], {"ids": ids},
                             program=main, scope=scope)
    want = exe.run(main.clone(for_test=True), feed={"ids": ids},
                   fetch_list=[logits], scope=scope)[0]
    np.testing.assert_allclose(inference.load_program(d).run({"ids": ids})[0],
                               want, rtol=1e-5, atol=1e-5)
    assert routes and all(routes)  # the attention took the flash route


def test_refuse_export_raises_only_while_exporting():
    _build.refuse_export("K2a (softmax_xent_fwd)")
    with _build.exporting():
        with pytest.raises(_build.ExportRefused, match="K2a"):
            _build.refuse_export("K2a (softmax_xent_fwd)")
    _build.refuse_export("K2a (softmax_xent_fwd)")


@pytest.mark.cuda
def test_on_the_card_an_export_through_a_kernel_raises_naming_it(
        tmp_path, flash_route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    main, startup, logits = build_lm()
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    ids = np.random.RandomState(2).randint(0, 64, (2, 256)).astype("int64")
    with pytest.raises(_build.ExportRefused, match=r"K1a \(flash_fwd\)"):
        inference.export_program(str(tmp_path / "lm"), ["ids"], [logits],
                                 {"ids": ids}, program=main, scope=scope)
