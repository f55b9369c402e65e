"""The port's model files and Predictor, against the JAX package's.

* A tiny BERT inference program (``bench.py``'s ``bench_bert_infer`` at
  ``BERT_TINY_CONFIG``, ``is_test``, dropout 0, the ``chain`` coupling and
  a float32 pooled fetch) saved by the JAX package with
  ``save_inference_model`` loads in the port (``load_inference_model`` and
  a ``Predictor`` on the CPU) and gives the JAX package's outputs to 1e-5;
  then the reverse.
* Both packages write the same desc, op for op, except one finding: the
  JAX package runs in 32-bit mode, so its shape inference records a var
  inferred as int64 (a ``cast`` to int64, the add on it) as int32. The
  port records int64. Neither package reads a non-data var's dtype when
  it runs, so both run either desc.
* ``prune_program`` keeps the JAX package's ops, in its order.
* ``tests/test_inference.py``'s cases, less StableHLO: the positional and
  handle APIs, ``reshape`` validation, handle reuse across batches, batch
  bucketing to powers of two (here: which feed batches the executor saw,
  each a captured step), and the exact re-run for a fetch that reduces
  over the batch. Bucketing is on by default in both packages (it bounds
  the captured steps, as it bounds the JAX package's recompiles).
* ``save_vars``/``load_vars`` round trips, combined and one file per var;
  the legacy q/k/v and Adam beta-pow migrations; bfloat16 refused.
* The device rule: the default ``AnalysisConfig`` asks for the card and
  the Predictor raises without one; ``load_vars`` puts each array on the
  executor's device.
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import inference as jinference
from paddle_tpu.core import serialization as jserial
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import inference
from paddle_tpu_torch.core import serialization as tserial
from paddle_tpu_torch.models import bert as tbert
from test_torch_bert import build_pretrain

SEQ, D = 16, tbert.BERT_TINY_CONFIG["d_model"]
FEEDS = ["ids", "pos", "sent", "mask", "chain"]
# vars whose dtype the JAX package's shape inference records as int32
INT64_AS_INT32 = {"cast_0.tmp_0", "elementwise_add_0.tmp_0"}


def build_infer(fluid, bert):
    """``bench_bert_infer``'s program at tiny size; returns (main,
    startup, pooled_f32)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[SEQ], dtype="int64")
        pos = fluid.layers.data("pos", shape=[SEQ], dtype="int64")
        sent = fluid.layers.data("sent", shape=[SEQ], dtype="int64")
        mask = fluid.layers.data("mask", shape=[SEQ], dtype="float32")
        chain = fluid.layers.data("chain", shape=[D])
        zero = fluid.layers.cast(
            fluid.layers.scale(fluid.layers.reduce_sum(chain), scale=0.0),
            "int64")
        ids2 = fluid.layers.elementwise_add(ids, zero)
        _, pooled = bert.bert_tiny(ids2, pos, sent, mask, dropout_rate=0.0,
                                   is_test=True)
        pooled_f32 = fluid.layers.cast(pooled, "float32")
    return main, startup, pooled_f32


def infer_feed(batch, seed=0):
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, 64, (batch, SEQ)).astype("int64"),
            "pos": np.tile(np.arange(SEQ), (batch, 1)).astype("int64"),
            "sent": rng.randint(0, 2, (batch, SEQ)).astype("int64"),
            "mask": (rng.rand(batch, SEQ) > 0.2).astype("float32"),
            "chain": rng.randn(batch, D).astype("float32")}


def cpu_config(model_dir):
    config = inference.AnalysisConfig(model_dir)
    config.disable_gpu()
    return config


def save_jax(model_dir, feed):
    """The JAX package saves the tiny BERT model; returns its output."""
    main, startup, out = build_infer(jfluid, jbert)
    with jfluid.scope_guard(jfluid.Scope()):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        want, = exe.run(main, feed=feed, fetch_list=[out])
        jfluid.io.save_inference_model(model_dir, FEEDS, [out], exe,
                                       main_program=main)
    return want


def save_port(model_dir, feed):
    main, startup, out = build_infer(tfluid, tbert)
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        want, = exe.run(main, feed=feed, fetch_list=[out])
        tfluid.io.save_inference_model(model_dir, FEEDS, [out], exe,
                                       main_program=main)
    return want


def test_jax_saved_model_predicts_in_the_port(tmp_path):
    feed = infer_feed(5)
    want = save_jax(str(tmp_path), feed)
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        prog, feeds, fetches = tfluid.io.load_inference_model(
            str(tmp_path), exe)
        assert feeds == FEEDS and len(fetches) == 1
        assert getattr(prog, "_amp_dtype", None) is None
        got, = exe.run(prog, feed=feed, fetch_list=fetches)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    out, = inference.create_predictor(cpu_config(str(tmp_path))).run(
        [feed[n] for n in FEEDS])
    assert out.shape == (5, D)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def test_port_saved_model_predicts_in_jax(tmp_path):
    feed = infer_feed(5)
    want = save_port(str(tmp_path), feed)
    with open(tmp_path / "__index__.json") as f:
        index = json.load(f)
    assert index["combined"] == "__params__"
    assert os.path.exists(tmp_path / "__params__.npz")
    out, = jinference.create_predictor(jinference.AnalysisConfig(
        str(tmp_path))).run([feed[n] for n in FEEDS])
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def test_descs_match_but_for_int64_dtypes(tmp_path):
    """The finding the cross-package files show, pinned: the saved descs
    agree key for key, op for op, and var for var but the dtype of vars
    inferred as int64."""
    feed = infer_feed(2)
    save_jax(str(tmp_path / "jax"), feed)
    save_port(str(tmp_path / "port"), feed)
    descs = []
    for side in ("jax", "port"):
        with open(tmp_path / side / "__model__") as f:
            descs.append(json.load(f))
    jdesc, tdesc = descs
    assert set(tdesc) == set(jdesc)
    assert {k: v for k, v in tdesc.items() if k != "blocks"} == \
        {k: v for k, v in jdesc.items() if k != "blocks"}
    jblk, tblk = jdesc["blocks"][0], tdesc["blocks"][0]
    assert tblk["ops"] == jblk["ops"]
    jvars = {v["name"]: v for v in jblk["vars"]}
    tvars = {v["name"]: v for v in tblk["vars"]}
    assert list(tvars) == list(jvars)
    differ = {n for n in jvars if tvars[n] != jvars[n]}
    assert differ == INT64_AS_INT32
    for n in differ:
        assert (jvars[n]["dtype"], tvars[n]["dtype"]) == ("int32", "int64")
        assert dict(tvars[n], dtype="int32") == jvars[n]


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "bf16_amp"])
def test_program_desc_round_trip_between_packages(amp):
    """``dumps``/``loads`` of the training program: the port reads the JAX
    package's desc to the same ops, vars and backward info it builds, and
    the JAX package reads the port's. Neither desc carries AMP."""
    cfg = tbert.BERT_TINY_CONFIG
    jm, _, _ = build_pretrain(jfluid, jbert, cfg, dropout=0.1, amp=amp)
    tm, _, _ = build_pretrain(tfluid, tbert, cfg, dropout=0.1, amp=amp)
    for prog in (tserial.loads(jserial.dumps(jm)),
                 jserial.loads(tserial.dumps(tm))):
        assert getattr(prog, "_amp_dtype", None) is None
        assert [(o.type, o.inputs, o.outputs, o.attrs)
                for o in prog.global_block.ops] == \
            [(o.type, o.inputs, o.outputs, o.attrs)
             for o in tm.global_block.ops]
        assert prog._backward_info == tm._backward_info
        assert {p.name: p.shape for p in prog.all_parameters()} == \
            {p.name: p.shape for p in tm.all_parameters()}
    assert tserial.dumps(tserial.loads(tserial.dumps(tm))) == \
        tserial.dumps(tm)
    with pytest.raises(ValueError, match="format version"):
        tserial.desc_to_program(dict(tserial.program_to_desc(tm),
                                     format_version=2))


def test_training_program_from_a_jax_desc_trains_in_the_port():
    """A program rebuilt from the JAX package's desc (its backward marker
    and Adam ops included) trains in the port as the program the port
    builds does, bit for bit."""
    cfg = tbert.BERT_TINY_CONFIG
    from test_torch_bert import pretrain_feed

    feed = pretrain_feed(cfg["vocab_size"])
    tm, ts, tloss = build_pretrain(tfluid, tbert, cfg)
    jm, _, _ = build_pretrain(jfluid, jbert, cfg)
    loaded = tserial.loads(jserial.dumps(jm))
    init = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(ts, scope=init)
    arrays = {n: init.as_numpy(n) for n in init.vars}
    losses = []
    for prog in (tm, loaded):
        scope = tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(),
                                           tfluid.CPUPlace())
        losses.append([float(exe.run(prog, feed=feed, fetch_list=[tloss.name],
                                     scope=scope)[0]) for _ in range(2)])
    assert losses[0] == losses[1]
    assert losses[0][1] < losses[0][0]


def test_prune_program_keeps_the_jax_ops():
    cfg = tbert.BERT_TINY_CONFIG
    pruned = []
    for fluid, bert in ((jfluid, jbert), (tfluid, tbert)):
        main, _, _ = build_pretrain(fluid, bert, cfg, dropout=0.1)
        pooled = next(op.output("Out")[0] for op in main.global_block.ops
                      if op.type == "tanh")
        prog = fluid.io.prune_program(main, ["ids", "pos", "sent", "mask"],
                                      [pooled])
        pruned.append([(op.type, op.attrs.get("is_test"))
                       for op in prog.global_block.ops])
    assert pruned[1] == pruned[0]
    types = [t for t, _ in pruned[1]]
    assert types[-1] == "tanh" and "adam" not in types
    assert "softmax_with_cross_entropy" not in types
    assert all(t for op, t in pruned[1] if op == "dropout")


# -- tests/test_inference.py's cases, on the port ------------------------------


def _train_and_save(tmp_path, rng):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[8])
        y = tfluid.layers.data("y", shape=[1], dtype="int64")
        h = tfluid.layers.fc(x, size=16, act="relu")
        logits = tfluid.layers.fc(h, size=4)
        probs = tfluid.layers.softmax(logits)
        loss = tfluid.layers.mean(
            tfluid.layers.softmax_with_cross_entropy(logits, y))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        xs = rng.randn(16, 8).astype("float32")
        ys = rng.randint(0, 4, (16, 1)).astype("int64")
        exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
        model_dir = str(tmp_path / "model")
        tfluid.io.save_inference_model(model_dir, ["x"], [probs], exe,
                                       main_program=main)
        want, = exe.run(main.clone(for_test=True), feed={"x": xs, "y": ys},
                        fetch_list=[probs])
    return model_dir, xs, want


def test_predictor_run_positional(tmp_path, rng):
    model_dir, xs, want = _train_and_save(tmp_path, rng)
    predictor = inference.create_predictor(cpu_config(model_dir))
    assert predictor.get_input_names() == ["x"]
    out, = predictor.run([xs])
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def test_predictor_handle_api(tmp_path, rng):
    model_dir, xs, want = _train_and_save(tmp_path, rng)
    predictor = inference.create_predictor(cpu_config(model_dir))
    h = predictor.get_input_handle("x")
    h.copy_from_cpu(xs)
    predictor.run()
    out_h = predictor.get_output_handle(predictor.get_output_names()[0])
    np.testing.assert_allclose(out_h.copy_to_cpu(), want, rtol=1e-5,
                               atol=1e-6)
    positional, = predictor.run([xs])
    np.testing.assert_array_equal(out_h.copy_to_cpu(), positional)


def test_predictor_batch_bucketing(tmp_path, rng, monkeypatch):
    """Batches 3, 5, 6 and 7 run as 4 and 8 and are sliced back; with
    bucketing off, each runs at its own size."""
    model_dir, xs, want = _train_and_save(tmp_path, rng)
    for bucketing, seen_want in ((True, [4, 8, 8, 8]), (False, [3, 5, 6, 7])):
        config = cpu_config(model_dir)
        config.switch_batch_bucketing(bucketing)
        predictor = inference.create_predictor(config)
        seen = []
        run = predictor._exe.run

        def counting(program, feed=None, **kw):
            seen.append(int(feed["x"].shape[0]))
            return run(program, feed=feed, **kw)

        monkeypatch.setattr(predictor._exe, "run", counting)
        for b in (3, 5, 6, 7):
            out, = predictor.run([xs[:b]])
            assert out.shape[0] == b, "padded rows leaked into the output"
            np.testing.assert_allclose(out, want[:b], rtol=1e-5, atol=1e-6)
        assert seen == seen_want


def test_bucketing_is_off_by_default(tmp_path, rng, monkeypatch):
    """The port's default config buckets, as the JAX package's does: a
    batch of 3 runs as 4 (one captured step) and is sliced back."""
    assert inference.AnalysisConfig().batch_bucketing()
    assert jinference.AnalysisConfig().batch_bucketing()
    model_dir, xs, want = _train_and_save(tmp_path, rng)
    predictor = inference.create_predictor(cpu_config(model_dir))
    seen = []
    run = predictor._exe.run

    def counting(program, feed=None, **kw):
        seen.append(int(feed["x"].shape[0]))
        return run(program, feed=feed, **kw)

    monkeypatch.setattr(predictor._exe, "run", counting)
    out, = predictor.run([xs[:3]])
    np.testing.assert_allclose(out, want[:3], rtol=1e-5, atol=1e-6)
    assert seen == [4]
    assert isinstance(predictor._compiled, tfluid.CompiledProgram)


def test_iohandle_reshape_validates_against_staged(tmp_path, rng):
    model_dir, xs, _ = _train_and_save(tmp_path, rng)
    predictor = inference.create_predictor(cpu_config(model_dir))
    h = predictor.get_input_handle("x")
    h.copy_from_cpu(xs[:4])
    with pytest.raises(ValueError, match="conflicts with already-staged"):
        h.reshape([8, 8])
    h.reshape([4, 8])  # matching declaration is fine
    with pytest.raises(ValueError, match="declared"):
        h.copy_from_cpu(xs[:2])  # violates the declared shape
    out_h = predictor.get_output_handle(predictor.get_output_names()[0])
    with pytest.raises(ValueError, match="input handles"):
        out_h.reshape([4, 4])


def test_iohandle_reuse_across_runs(tmp_path, rng):
    model_dir, xs, want = _train_and_save(tmp_path, rng)
    predictor = inference.create_predictor(cpu_config(model_dir))
    h = predictor.get_input_handle("x")
    out_name = predictor.get_output_names()[0]
    for b in (4, 2, 7):
        h.reshape([b, 8])
        h.copy_from_cpu(xs[:b])
        predictor.run()
        got = predictor.get_output_handle(out_name).copy_to_cpu()
        assert got.shape[0] == b
        np.testing.assert_allclose(got, want[:b], rtol=1e-5, atol=1e-6)


def test_bucketing_batch_reduced_fetch_stays_exact(tmp_path, rng):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[8])
        out = tfluid.layers.fc(x, size=4, act="softmax")
        m = tfluid.layers.mean(out)
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        model_dir = str(tmp_path / "redmodel")
        tfluid.io.save_inference_model(model_dir, ["x"], [out, m], exe,
                                       main_program=main)
        xs = rng.randn(5, 8).astype("float32")
        want_out, want_m = exe.run(main.clone(for_test=True),
                                   feed={"x": xs}, fetch_list=[out, m])
    config = cpu_config(model_dir)
    config.switch_batch_bucketing(True)
    predictor = inference.create_predictor(config)
    got_out, got_m = predictor.run([xs])
    assert got_out.shape[0] == 5
    np.testing.assert_allclose(got_out, want_out, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_m, want_m, rtol=1e-5, atol=1e-6)


# -- save_vars / load_vars ----------------------------------------------------


def _mlp_scope(fluid_seed=0):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[8])
        y = tfluid.layers.data("y", shape=[1], dtype="int64")
        logits = tfluid.layers.fc(tfluid.layers.fc(x, 16, act="relu"), 4)
        loss = tfluid.layers.mean(
            tfluid.layers.softmax_with_cross_entropy(logits, y))
        tfluid.optimizer.Adam(1e-2).minimize(loss)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(fluid_seed)
    feed = {"x": rng.randn(8, 8).astype("float32"),
            "y": rng.randint(0, 4, (8, 1)).astype("int64")}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return main, scope, exe, feed, loss


@pytest.mark.parametrize("filename", [None, "all_vars"])
def test_save_load_persistables_round_trip(tmp_path, filename):
    main, scope, exe, feed, loss = _mlp_scope()
    with tfluid.scope_guard(scope):
        tfluid.io.save_persistables(exe, str(tmp_path), main_program=main,
                                    filename=filename)
    names = sorted(v.name for v in main.list_vars()
                   if v.persistable and not v.is_data)
    with open(tmp_path / "__index__.json") as f:
        assert json.load(f) == {"vars": names, "combined": filename}
    fresh = tfluid.Scope()
    with tfluid.scope_guard(fresh):
        tfluid.io.load_persistables(exe, str(tmp_path), main_program=main,
                                    filename=filename)
    assert sorted(fresh.vars) == names
    for n in names:
        assert fresh.find_var(n).device == torch.device("cpu")
        np.testing.assert_array_equal(fresh.as_numpy(n), scope.as_numpy(n))
    # the JAX package reads the same files
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.io.load_vars(None, str(tmp_path), filename=filename)
    for n in names:
        np.testing.assert_array_equal(np.asarray(jscope.find_var(n)),
                                      scope.as_numpy(n))
    # the resumed run continues exactly
    want = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
    got = exe.run(main, feed=feed, fetch_list=[loss], scope=fresh)[0]
    np.testing.assert_array_equal(got, want)


def test_save_params_saves_parameters_only(tmp_path):
    main, scope, exe, _, _ = _mlp_scope()
    with tfluid.scope_guard(scope):
        tfluid.io.save_params(exe, str(tmp_path), main_program=main)
    with open(tmp_path / "__index__.json") as f:
        saved = json.load(f)["vars"]
    assert saved == sorted(p.name for p in main.all_parameters())
    assert all(os.path.exists(tmp_path / (n + ".npy")) for n in saved)


def test_load_vars_migrates_split_qkv_and_beta_pows(tmp_path):
    """Checkpoints of builds that stored q/k/v apart, or one beta-pow pair
    per parameter, load into the merged layout."""
    d_model, n_head, seq = 16, 2, 8
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[seq, d_model], dtype="float32")
        tfluid.layers.attention.multi_head_attention(
            x, None, None, None, d_model // n_head, d_model // n_head,
            d_model, n_head, is_test=True, name="mha")
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    qkv = [n for n in scope.vars if "_qkv" in n]
    assert qkv
    old = {}
    for n in scope.vars:
        arr = scope.as_numpy(n)
        if n in qkv:
            for i, s in enumerate(("_q", "_k", "_v")):
                old[n.replace("_qkv", s, 1)] = arr[:, i * d_model:
                                                   (i + 1) * d_model]
        else:
            old[n] = arr
    pow_name = "fc_0.w_0_adam_0_beta1_pow_acc_0"
    old["fc_1.w_0_adam_0_beta1_pow_acc_0"] = np.float32([0.81])
    np.savez(tmp_path / "old.npz", **old)
    with open(tmp_path / "__index__.json", "w") as f:
        json.dump({"vars": sorted(old), "combined": "old"}, f)
    fresh = tfluid.Scope()
    with tfluid.scope_guard(fresh):
        tfluid.io.load_vars(exe, str(tmp_path), main_program=main,
                            filename="old")
        tfluid.io.load_vars(exe, str(tmp_path), vars=[pow_name],
                            filename="old")
    for n in scope.vars:
        np.testing.assert_array_equal(fresh.as_numpy(n), scope.as_numpy(n))
    np.testing.assert_array_equal(fresh.as_numpy(pow_name),
                                  np.float32([0.81]))


def test_save_vars_refuses_bfloat16_and_missing(tmp_path):
    scope = tfluid.Scope()
    scope.set_var("w", torch.ones(3, dtype=torch.bfloat16))
    with tfluid.scope_guard(scope):
        with pytest.raises(TypeError, match="bfloat16"):
            tfluid.io.save_vars(None, str(tmp_path), vars=["w"])
        with pytest.raises(RuntimeError, match="not found"):
            tfluid.io.save_vars(None, str(tmp_path), vars=["nope"])
    with tfluid.scope_guard(tfluid.Scope()):
        tfluid.io.save_vars(None, str(tmp_path), vars=[], filename=None)
        with pytest.raises(RuntimeError, match="missing"):
            tfluid.io.load_vars(tfluid.Executor(tfluid.CPUPlace()),
                                str(tmp_path), vars=["w"])


# -- the device rule ----------------------------------------------------------


def test_default_config_asks_for_the_card_and_raises_without_one(
        tmp_path, monkeypatch):
    feed = infer_feed(2)
    save_port(str(tmp_path), feed)
    config = inference.AnalysisConfig(str(tmp_path))
    assert config.use_gpu() and config.gpu_device_id() == 0
    config.enable_use_gpu(device_id=1)
    assert config.use_gpu() and config.gpu_device_id() == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.create_predictor(inference.AnalysisConfig(str(tmp_path)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfluid.io.load_inference_model(str(tmp_path), None)
    config.disable_gpu()
    assert not config.use_gpu()
    out, = inference.create_predictor(config).run([feed[n] for n in FEEDS])
    assert out.shape == (2, D)
