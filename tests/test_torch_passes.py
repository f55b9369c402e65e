"""The port's Program-pass pipeline against the JAX package's, on the CPU.

``paddle_tpu_torch.passes`` is a copy of ``paddle_tpu.passes`` over the
port's Program IR. These tests hold it to the reference:

* each pass of ``tests/test_graph_passes.py``, on the same program built
  in both packages, leaves the same op-type sequence and reports the same
  ``ops_removed`` / ``rewrites_matched`` / ``fused_count``;
* the pipeline's results against the JAX package's: ``softmax`` +
  ``cross_entropy`` fused (losses over 3 SGD steps), the attention
  rewrite with and without a bias (outputs), conv+bn folding on a
  test-size inference ResNet (outputs and the folded weights), and
  ``bench.py``'s ``bench_transformer`` program built under
  ``FLAGS_unfused_attention`` at 2+2 layers, d_model 64, seq 16, vocab
  100 (the rewrite count, the op types after the pipeline, the losses of
  3 Adam steps), all to 1e-5 from the JAX package's startup state
  (``io.state_from_numpy``), dropout 0;
* in the port alone: level 1 bit-equal to level 0 with dropout before and
  after a deleted op, memoization, idempotence, the source untouched,
  ``PADDLE_TPU_PASS_<NAME>=0``, level 0, and a failing build pass named
  with the ``CompiledProgram`` left untouched;
* the ops the layers emit and the pipeline reads (``matmul``,
  ``cross_entropy``, ``equal``) against the JAX package's ops, 1e-6.
"""

import os
from collections import Counter

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core.pass_framework import get_pass as jget_pass
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import transformer as jtfm
from paddle_tpu.passes.pipeline import optimize_program as joptimize
from paddle_tpu_torch.core.pass_framework import (FunctionPass, Pass,
                                                   PassBuilder, PassError,
                                                   get_pass as tget_pass)
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import transformer as ttfm
from paddle_tpu_torch.monitor import metrics
from paddle_tpu_torch.passes.pipeline import (maybe_optimize,
                                              optimize_program as toptimize)

CPU = tfluid.CPUPlace()
PKG = {"jax": jfluid, "torch": tfluid}


def op_types(program):
    return [op.type for op in program.global_block.ops]


def count(program, op_type):
    return sum(1 for op in program.global_block.ops if op.type == op_type)


def jax_scope(startup):
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return scope


def port_scope(main, jscope):
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
    return tfluid.io.state_from_numpy(main, arrays, tfluid.Scope(), CPU)


def jax_run(main, scope, feed, fetch, steps=1):
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        return [exe.run(main, feed=feed, fetch_list=fetch)
                for _ in range(steps)]


def port_run(main, scope, feed, fetch, steps=1):
    exe = tfluid.Executor(CPU)
    return [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            for _ in range(steps)]


# -- programs, each built the same way in both packages -----------------------


def mlp_with_baggage(fluid, dropout=0.0):
    """``tests/test_graph_passes.py``'s MLP: an unfetched accuracy branch,
    a constant chain and a duplicated subexpression."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[16])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, size=24, act="relu")
        if dropout:
            h = fluid.layers.dropout(
                h, dropout, dropout_implementation="upscale_in_train")
        logits = fluid.layers.fc(h, size=10)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.layers.accuracy(fluid.layers.softmax(logits), y)
        c = fluid.layers.fill_constant([1], "float32", 2.0)
        fluid.layers.scale(c, scale=3.0)
        a = fluid.layers.scale(h, scale=2.0)
        b = fluid.layers.scale(h, scale=2.0)
        fluid.layers.elementwise_add(a, b)
        fluid.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, [loss]


def const_chain(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[4])
        c = fluid.layers.fill_constant([4], "float32", 2.0)
        c = fluid.layers.scale(c, scale=3.0, bias=1.0)
        out = fluid.layers.elementwise_add(x, c)
    return main, startup, [out]


def startup_of_fc(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[4])
        fluid.layers.fc(x, size=3)
    return startup, None, []


def cse_duplicates(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[4])
        a = fluid.layers.scale(x, scale=2.0)
        b = fluid.layers.scale(x, scale=2.0)
        c = fluid.layers.scale(x, scale=5.0)
        out = fluid.layers.elementwise_add(
            fluid.layers.elementwise_add(a, b), c)
    return main, startup, [out]


def cse_redefined(fluid, alias):
    """Two equal scales with the name of one redefined between (``alias``:
    the duplicate's name, else the first one's)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[4])
        a = fluid.layers.scale(x, scale=2.0)
        b = fluid.layers.scale(x, scale=2.0) if alias else a
        main.global_block.append_op(
            "scale", inputs={"X": x}, outputs={"Out": b},
            attrs={"scale": 5.0 if alias else 7.0, "bias": 0.0,
                   "bias_after_scale": True})
        if alias:
            out = fluid.layers.elementwise_add(a, fluid.layers.relu(b))
        else:
            out = fluid.layers.elementwise_add(
                a, fluid.layers.scale(x, scale=2.0))
    return main, startup, [out]


def softmax_xent(fluid, fetch_probs=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[8])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        logits = fluid.layers.fc(x, size=5)
        probs = fluid.layers.softmax(logits)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(probs, y))
        if not fetch_probs:
            fluid.optimizer.SGD(0.5).minimize(loss)
    return main, startup, [loss, probs] if fetch_probs else [loss]


def unfused_attention(fluid, dropout=0.0, with_bias=True, fetch_probs=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        q, k, v = (fluid.layers.data(n, shape=[2, 8, 4]) for n in "qkv")
        scores = fluid.layers.matmul(q, k, transpose_y=True, alpha=0.5)
        if with_bias:
            bias = fluid.layers.data("bias", shape=[2, 8, 8])
            scores = fluid.layers.elementwise_add(scores, bias)
        probs = fluid.layers.softmax(scores)
        if dropout:
            probs = fluid.layers.dropout(
                probs, dropout, dropout_implementation="upscale_in_train")
        out = fluid.layers.matmul(probs, v)
        red = fluid.layers.mean(out)
    return main, startup, [red, probs] if fetch_probs else [red]


def conv_bn_inference(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", shape=[3, 8, 8])
        c = fluid.layers.conv2d(img, num_filters=5, filter_size=3)
        out = fluid.layers.relu(fluid.layers.batch_norm(c, is_test=True))
    return main, startup, [out]


PROGRAMS = {
    "mlp_with_baggage": mlp_with_baggage,
    "mlp_with_dropout": lambda f: mlp_with_baggage(f, dropout=0.2),
    "const_chain": const_chain,
    "startup_of_fc": startup_of_fc,
    "cse_duplicates": cse_duplicates,
    "cse_alias_dies": lambda f: cse_redefined(f, alias=True),
    "cse_redefinition": lambda f: cse_redefined(f, alias=False),
    "softmax_xent": softmax_xent,
    "softmax_fetched": lambda f: softmax_xent(f, fetch_probs=True),
    "attention_bias": unfused_attention,
    "attention_no_bias": lambda f: unfused_attention(f, with_bias=False),
    "attention_dropout": lambda f: unfused_attention(f, dropout=0.3),
    "attention_fetched": lambda f: unfused_attention(f, fetch_probs=True),
    "conv_bn": conv_bn_inference,
}

# (pass, program): every pass on every program of test_graph_passes.py
# that exercises it, plus the whole pipeline on each program
PASS_CASES = [
    ("dead_code_elimination", "mlp_with_baggage"),
    ("constant_folding", "const_chain"),
    ("constant_folding", "startup_of_fc"),
    ("constant_folding", "mlp_with_baggage"),
    ("common_subexpression_elimination", "cse_duplicates"),
    ("common_subexpression_elimination", "cse_alias_dies"),
    ("common_subexpression_elimination", "cse_redefinition"),
    ("common_subexpression_elimination", "mlp_with_baggage"),
    ("softmax_xent_fuse_pass", "softmax_xent"),
    ("softmax_xent_fuse_pass", "softmax_fetched"),
    ("flash_attention_rewrite", "attention_bias"),
    ("flash_attention_rewrite", "attention_no_bias"),
    ("flash_attention_rewrite", "attention_dropout"),
    ("flash_attention_rewrite", "attention_fetched"),
    ("conv_bn_fuse_pass", "conv_bn"),
] + [("pipeline", name) for name in PROGRAMS]

REPORTS = ("ops_removed", "vars_removed", "rewrites_matched", "fused_count")


def _apply(side, pass_name, program, fetch, scope):
    names = tuple(v.name for v in fetch)
    if pass_name == "pipeline":
        opt = (joptimize if side == "jax" else toptimize)(
            program, names, scope)
        return opt, {}
    p = (jget_pass if side == "jax" else tget_pass)(pass_name)
    p.set_attr("fetch_names", names)
    if scope is not None:
        p.set_attr("scope", scope)
    work = program.clone()
    work = p.apply(work)
    return work, {k: p.attr(k) for k in REPORTS if p.has_attr(k)}


@pytest.mark.parametrize("pass_name,program", PASS_CASES,
                         ids=["%s-%s" % c for c in PASS_CASES])
def test_each_pass_matches_the_jax_package(pass_name, program):
    build = PROGRAMS[program]
    jmain, jstart, jfetch = build(jfluid)
    tmain, tstart, tfetch = build(tfluid)
    assert op_types(jmain) == op_types(tmain)
    jsc = tsc = None
    if jstart is not None:
        jsc = jax_scope(jstart)
        tsc = port_scope(tmain, jsc)
    jout, jrep = _apply("jax", pass_name, jmain, jfetch, jsc)
    tout, trep = _apply("torch", pass_name, tmain, tfetch, tsc)
    assert op_types(tout) == op_types(jout)
    assert trep == jrep
    assert [sorted(op.inputs.items()) for op in tout.global_block.ops] == \
        [sorted(op.inputs.items()) for op in jout.global_block.ops]


# -- results against the JAX package ------------------------------------------


def test_softmax_xent_fuse_trains_like_the_jax_package():
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(8, 8).astype("float32"),
            "y": rng.randint(0, 5, (8, 1)).astype("int64")}
    jmain, jstart, (jloss,) = softmax_xent(jfluid)
    tmain, tstart, (tloss,) = softmax_xent(tfluid)
    jsc = jax_scope(jstart)
    tsc = port_scope(tmain, jsc)
    want = jax_run(jmain, jsc, feed, [jloss], steps=3)
    got = port_run(tmain, tsc, feed, [tloss], steps=3)
    opt = maybe_optimize(tmain, (tloss.name,), tsc)
    assert count(opt, "softmax_with_cross_entropy") == 1
    assert count(opt, "cross_entropy") == count(opt, "softmax") == 0
    np.testing.assert_allclose(np.ravel(got), np.ravel(want), rtol=1e-5)
    assert got[-1][0] < got[0][0]


@pytest.mark.parametrize("with_bias", [True, False])
def test_attention_rewrite_matches_the_jax_package(with_bias):
    rng = np.random.RandomState(1)
    feed = {n: rng.randn(3, 2, 8, 4).astype("float32") for n in "qkv"}
    if with_bias:
        feed["bias"] = rng.randn(3, 2, 8, 8).astype("float32") * 0.1
    jmain, _, (jred,) = unfused_attention(jfluid, with_bias=with_bias)
    tmain, _, (tred,) = unfused_attention(tfluid, with_bias=with_bias)
    (want,), = jax_run(jmain, jfluid.Scope(), feed, [jred])
    (got,), = port_run(tmain, tfluid.Scope(), feed, [tred])
    opt = maybe_optimize(tmain, (tred.name,), None)
    sdpa = [op for op in opt.global_block.ops
            if op.type == "scaled_dot_product_attention"]
    assert len(sdpa) == 1 and count(opt, "matmul") == 0
    assert sdpa[0].attr("sm_scale") == pytest.approx(0.5)
    assert bool(sdpa[0].inputs.get("Bias")) == with_bias
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def resnet_inference(fluid, resnet):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", shape=[3, 32, 32])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        out = resnet.resnet(img, label, depth=18, class_num=10,
                            dataset="cifar10")
    infer = main.clone(for_test=True)
    return infer, startup, out[0] if isinstance(out, tuple) else out


def test_conv_bn_fold_on_an_inference_resnet_matches_the_jax_package():
    jmain, jstart, jout = resnet_inference(jfluid, jresnet)
    tmain, tstart, tout = resnet_inference(tfluid, tresnet)
    assert count(tmain, "batch_norm") > 0
    jsc = jax_scope(jstart)
    rng = np.random.RandomState(2)
    stats = 0
    for v in jmain.list_vars():
        if v.persistable and ".mean_" in v.name:
            jsc.set_var(v.name, rng.randn(*v.shape).astype("float32") * 0.1)
            stats += 1
        if v.persistable and ".var_" in v.name:
            jsc.set_var(v.name, np.abs(rng.randn(*v.shape)).astype(
                "float32") + 0.5)
            stats += 1
    assert stats == 2 * count(jmain, "batch_norm")
    tsc = port_scope(tmain, jsc)
    feed = {"img": rng.randn(2, 3, 32, 32).astype("float32"),
            "label": np.zeros((2, 1), "int64")}
    (want,), = jax_run(jmain, jsc, feed, [jout])
    (got,), = port_run(tmain, tsc, feed, [tout])
    jopt = joptimize(jmain, (jout.name,), jsc)
    topt = maybe_optimize(tmain, (tout.name,), tsc)
    assert count(topt, "batch_norm") == count(jopt, "batch_norm") == 0
    assert op_types(topt) == op_types(jopt)
    folded = sorted(n for n in tsc.vars if n.endswith(
        (".bn_fused", ".bn_fold_bias")))
    assert folded and folded == sorted(n for n in jsc.vars if n.endswith(
        (".bn_fused", ".bn_fold_bias")))
    for n in folded:
        np.testing.assert_allclose(tsc.as_numpy(n), np.asarray(jsc.vars[n]),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    # 18 layers of float32 convolutions in two libraries: 1e-5 of the
    # logits' scale (level 0 differs by 1e-6 of it)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


SEQ, VOCAB, BATCH = 16, 100, 4


def bench_transformer_program(fluid, tfm, dropout=0.0):
    """``bench.py``'s ``bench_transformer`` program at test size, float32:
    built under ``set_flag("unfused_attention", True)`` exactly as the
    bench builds it."""
    main, startup = fluid.Program(), fluid.Program()
    prev = fluid.get_flag("unfused_attention")
    fluid.set_flag("unfused_attention", True)
    try:
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            src = fluid.layers.data("src", shape=[SEQ], dtype="int64")
            trg = fluid.layers.data("trg", shape=[SEQ], dtype="int64")
            lbl = fluid.layers.data("lbl", shape=[SEQ, 1], dtype="int64")
            smask = fluid.layers.data("smask", shape=[SEQ], dtype="float32")
            tmask = fluid.layers.data("tmask", shape=[SEQ], dtype="float32")
            _, loss = tfm.transformer(
                src, trg, lbl, smask, tmask, VOCAB, VOCAB, max_length=SEQ,
                n_layer=2, n_head=4, d_model=64, d_inner=128,
                dropout_rate=dropout)
            fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    finally:
        fluid.set_flag("unfused_attention", prev)
    return main, startup, loss


def bench_feed(seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((BATCH, SEQ), "float32")
    mask[1, SEQ // 2:] = 0.0  # one padded row: the segment bias masks it
    return {"src": rng.randint(2, VOCAB, (BATCH, SEQ)).astype("int64"),
            "trg": rng.randint(2, VOCAB, (BATCH, SEQ)).astype("int64"),
            "lbl": rng.randint(2, VOCAB, (BATCH, SEQ, 1)).astype("int64"),
            "smask": mask, "tmask": mask.copy()}


def test_bench_transformer_unfused_matches_the_jax_package():
    jmain, jstart, jloss = bench_transformer_program(jfluid, jtfm)
    tmain, tstart, tloss = bench_transformer_program(tfluid, ttfm)
    assert op_types(tmain) == op_types(jmain)
    assert count(tmain, "matmul") == 2 * 4  # 2 encoder + 2 cross sites
    jsc = jax_scope(jstart)
    tsc = port_scope(tmain, jsc)
    p_j = jget_pass("flash_attention_rewrite")
    p_t = tget_pass("flash_attention_rewrite")
    for p, prog in ((p_j, jmain), (p_t, tmain)):
        p.set_attr("fetch_names", (jloss.name,))
        p.apply(prog.clone())
    assert p_t.attr("rewrites_matched") == p_j.attr("rewrites_matched") == 4
    jopt = joptimize(jmain, (jloss.name,), jsc)
    topt = toptimize(tmain, (tloss.name,), tsc)
    assert op_types(topt) == op_types(jopt)
    assert count(topt, "scaled_dot_product_attention") == 6  # + 2 causal
    assert count(topt, "matmul") == 0
    feed = bench_feed()
    want = jax_run(jmain, jsc, feed, [jloss], steps=3)
    got = port_run(tmain, tsc, feed, [tloss], steps=3)
    np.testing.assert_allclose(np.ravel(got), np.ravel(want), rtol=1e-5)


def test_unfused_program_runs_as_the_fused_built_one():
    """At dropout 0 the rewritten program's losses equal those of the
    program built with the fused op (its segment ids a where-mask, here an
    additive bias) from the same state, and the op types differ only by
    the segment-bias chain."""
    feed = bench_feed(1)
    tmain, tstart, tloss = bench_transformer_program(tfluid, ttfm)
    fmain, fstart = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(fmain, fstart), tfluid.unique_name.guard():
        ins = [tfluid.layers.data(n, shape=[SEQ], dtype="int64")
               for n in ("src", "trg")]
        lbl = tfluid.layers.data("lbl", shape=[SEQ, 1], dtype="int64")
        masks = [tfluid.layers.data(n, shape=[SEQ], dtype="float32")
                 for n in ("smask", "tmask")]
        _, floss = ttfm.transformer(*ins, lbl, *masks, VOCAB, VOCAB,
                                    max_length=SEQ, n_layer=2, n_head=4,
                                    d_model=64, d_inner=128, dropout_rate=0.0)
        tfluid.optimizer.Adam(learning_rate=1e-4).minimize(floss)
    sc = tfluid.Scope()
    tfluid.Executor(CPU).run(tstart, scope=sc)
    arrays = {n: sc.as_numpy(n) for n in sc.vars}
    fsc = tfluid.io.state_from_numpy(fmain, arrays, tfluid.Scope(), CPU)
    got = port_run(tmain, sc, feed, [tloss], steps=3)
    want = port_run(fmain, fsc, feed, [floss], steps=3)
    np.testing.assert_allclose(np.ravel(got), np.ravel(want), rtol=1e-6)
    opt = maybe_optimize(tmain, (tloss.name,), sc)
    fopt = maybe_optimize(fmain, (floss.name,), fsc)
    extra = Counter(op_types(opt)) - Counter(op_types(fopt))
    assert extra == Counter({"unsqueeze": 5, "equal": 2, "cast": 2,
                             "scale": 2})
    assert not Counter(op_types(fopt)) - Counter(op_types(opt))


# -- the pipeline's contract, in the port alone -------------------------------


def _signature(program):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
             sorted((k, repr(v)) for k, v in op.attrs.items()))
            for op in program.global_block.ops]


def test_pipeline_idempotent_memoized_and_source_untouched():
    main, startup, (loss,) = mlp_with_baggage(tfluid, dropout=0.2)
    scope = tfluid.Scope()
    tfluid.Executor(CPU).run(startup, scope=scope)
    before = _signature(main)
    opt1 = toptimize(main, (loss.name,), scope)
    opt2 = toptimize(opt1, (loss.name,), scope)
    assert _signature(opt1) == _signature(opt2)
    assert _signature(main) == before
    assert len(opt1.global_block.ops) < len(main.global_block.ops)
    runs = metrics.PASS_RUNS.value
    exe = tfluid.Executor(CPU)
    feed = {"x": np.ones((4, 16), "float32"),
            "y": np.zeros((4, 1), "int64")}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    memo = next(iter(main._opt_cache[1].values()))[1]
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert next(iter(main._opt_cache[1].values()))[1] is memo
    if metrics.enabled():
        assert metrics.PASS_RUNS.value == runs + 1
    assert _signature(main) == before


def test_level_one_bit_equal_to_level_zero_with_dropout(monkeypatch):
    """Dead ops before AND after the dropout: DCE deletes them, and the
    stamped RNG slots keep every generator stream where it was."""

    def run_level(level):
        monkeypatch.setenv("PADDLE_TPU_OPT_LEVEL", str(level))
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = startup.random_seed = 5
        with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
            x = tfluid.layers.data("x", shape=[16])
            y = tfluid.layers.data("y", shape=[1], dtype="int64")
            c = tfluid.layers.fill_constant([1], "float32", 2.0)
            tfluid.layers.scale(c, scale=3.0)
            h = tfluid.layers.fc(x, size=24, act="relu")
            h = tfluid.layers.dropout(
                h, 0.4, dropout_implementation="upscale_in_train")
            tfluid.layers.scale(h, scale=4.0)  # dead, after the dropout
            h = tfluid.layers.fc(h, size=24, act="relu")
            h = tfluid.layers.dropout(
                h, 0.3, dropout_implementation="upscale_in_train")
            logits = tfluid.layers.fc(h, size=10)
            loss = tfluid.layers.mean(
                tfluid.layers.softmax_with_cross_entropy(logits, y))
            tfluid.optimizer.Adam(1e-3).minimize(loss)
        scope = tfluid.Scope()
        exe = tfluid.Executor(CPU)
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(7)
        feed = {"x": rng.randn(8, 16).astype("float32"),
                "y": rng.randint(0, 10, (8, 1)).astype("int64")}
        out = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
               for _ in range(5)]
        opt = exe._maybe_optimize(main, (loss.name,), scope)
        if level:
            assert len(opt.global_block.ops) < len(main.global_block.ops) - 2
        else:
            assert opt is main
        return out, scope

    l0, s0 = run_level(0)
    l1, s1 = run_level(1)
    for a, b in zip(l0, l1):
        np.testing.assert_array_equal(a, b)
    for n in s0.vars:
        np.testing.assert_array_equal(s0.as_numpy(n), s1.as_numpy(n))


def test_memo_serves_every_scope_unless_it_folded_values():
    """A clone that read no scope value serves any scope (the eager scope
    and the captured copy of it alternate); a conv+bn fold is tied to the
    scope it read."""
    main, startup, (loss,) = mlp_with_baggage(tfluid)
    a, b = tfluid.Scope(), tfluid.Scope()
    assert maybe_optimize(main, (loss.name,), a) is \
        maybe_optimize(main, (loss.name,), b)
    main, startup, (out,) = conv_bn_inference(tfluid)
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=a)
    exe.run(startup, scope=b)
    fa_ = maybe_optimize(main, (out.name,), a)
    assert count(fa_, "batch_norm") == 0
    assert maybe_optimize(main, (out.name,), a) is fa_
    fb = maybe_optimize(main, (out.name,), b)
    assert fb is not fa_ and count(fb, "batch_norm") == 0


def test_per_pass_env_gate(monkeypatch):
    main, startup, (loss,) = mlp_with_baggage(tfluid)
    monkeypatch.setenv("PADDLE_TPU_PASS_DEAD_CODE_ELIMINATION", "0")
    opt = toptimize(main, (loss.name,), None)
    assert count(opt, "accuracy") == 1
    memo_off = maybe_optimize(main, (loss.name,), None)
    monkeypatch.delenv("PADDLE_TPU_PASS_DEAD_CODE_ELIMINATION")
    assert count(toptimize(main, (loss.name,), None), "accuracy") == 0
    memo_on = maybe_optimize(main, (loss.name,), None)
    assert memo_on is not memo_off and count(memo_on, "accuracy") == 0


@pytest.mark.parametrize("pkg", sorted(PKG))
def test_gate_overrides_switch_a_pass_off_for_a_while(pkg, monkeypatch):
    """``pass_gate_overrides`` (the JAX package's autotuner measures gate
    sets through it) turns DCE off inside the block only, and the memo
    hands out a clone per gate set, in both packages alike."""
    fluid = PKG[pkg]
    if pkg == "jax":
        from paddle_tpu.passes.pipeline import (maybe_optimize as memo,
                                                pass_gate_overrides)
    else:
        from paddle_tpu_torch.passes.pipeline import (
            maybe_optimize as memo, pass_gate_overrides)
    monkeypatch.delenv("PADDLE_TPU_PASS_DEAD_CODE_ELIMINATION", raising=False)
    main, startup, (loss,) = mlp_with_baggage(fluid)
    on = memo(main, (loss.name,), None)
    with pass_gate_overrides(["dead_code_elimination"]):
        off = memo(main, (loss.name,), None)
    assert count(on, "accuracy") == 0 and count(off, "accuracy") == 1
    assert "PADDLE_TPU_PASS_DEAD_CODE_ELIMINATION" not in os.environ
    assert memo(main, (loss.name,), None) is on


def test_op_slots_match_the_jax_package():
    """Every op of the optimized clone carries its source position in
    ``__op_slot__`` (the JAX package attributes per-op device time and
    numerics by it); the port stamps the same slots."""
    slots = {}
    for pkg, optimize in (("jax", joptimize), ("torch", toptimize)):
        main, startup, (loss,) = mlp_with_baggage(PKG[pkg], dropout=0.2)
        opt = optimize(main, (loss.name,), None)
        slots[pkg] = [(op.type, op.attrs.get("__op_slot__"))
                      for op in opt.global_block.ops]
    assert all(s is not None for _, s in slots["torch"])
    assert slots["torch"] == slots["jax"]


def test_opt_level_zero_disables_everything(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_OPT_LEVEL", "0")
    main, startup, (loss,) = mlp_with_baggage(tfluid)
    assert tfluid.Executor(CPU)._maybe_optimize(main, (loss.name,),
                                                None) is main


def test_apply_all_names_the_failing_pass():
    def boom(program, p):
        raise ValueError("kaboom")

    builder = PassBuilder([FunctionPass("fine_pass", lambda prog, p: None),
                           FunctionPass("exploding_pass", boom)])
    with pytest.raises(PassError, match="exploding_pass"):
        builder.apply_all(tfluid.Program())


def test_compiled_program_left_untouched_on_pass_failure():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", shape=[4])
        loss = tfluid.layers.mean(tfluid.layers.fc(x, size=3))

    class Mutator(Pass):
        name = "mutating_pass"

        def apply_impl(self, program):
            program.global_block.append_op(
                "scale", inputs={"X": loss.name}, outputs={"Out": loss.name},
                attrs={"scale": 1.0})

    def boom(program, p):
        raise RuntimeError("mid-pipeline failure")

    bs = tfluid.BuildStrategy()
    bs.pass_builder().append_pass(Mutator())
    bs.pass_builder().append_pass(FunctionPass("late_boom", boom))
    compiled = tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    n_ops, version = len(main.global_block.ops), main._version
    with pytest.raises(PassError, match="late_boom"):
        exe.run(compiled, feed={"x": np.ones((2, 4), "float32")},
                fetch_list=[loss], scope=scope)
    assert len(main.global_block.ops) == n_ops
    assert main._version == version
    assert compiled._program is main


def test_user_pass_runs_after_the_fetch_safe_defaults():
    """A user pass sees the RNG-stamped clone; a constant leaf stays
    fetchable (the build step runs without fetch info)."""
    seen = []
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", shape=[4])
        h = tfluid.layers.dropout(tfluid.layers.fc(x, size=3), 0.5)
        loss = tfluid.layers.mean(h)
        d = tfluid.layers.scale(
            tfluid.layers.fill_constant([1], "float32", 2.0), scale=0.5)
    bs = tfluid.BuildStrategy()
    bs.pass_builder().append_pass(FunctionPass(
        "spy", lambda p, s: seen.append(
            [op.attr("__rng_slot__") for op in p.global_block.ops
             if op.type == "dropout"])))
    compiled = tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    _, dv = exe.run(compiled, feed={"x": np.ones((8, 4), "float32")},
                    fetch_list=[loss, d], scope=scope)
    assert float(np.ravel(dv)[0]) == pytest.approx(1.0)
    assert seen == [[2]]
    assert compiled._program is not main


# -- the new ops against the JAX package's ------------------------------------


MATMULS = [((3, 4), (4, 5), False, False, 1.0),
           ((4, 3), (4, 5), True, False, 0.5),
           ((2, 3, 4), (2, 5, 4), False, True, 1.0),
           ((2, 2, 3, 4), (2, 2, 3, 5), True, False, 0.125),
           ((2, 2, 3, 4), (4, 5), False, False, 2.0),
           ((2, 3, 4, 6), (2, 3, 5, 6), False, True, 0.3)]


def _forward(side, build, feed):
    fluid = PKG[side]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = build(fluid)
    if side == "jax":
        (res,), = jax_run(main, jfluid.Scope(), feed, [out])
    else:
        (res,), = port_run(main, tfluid.Scope(), feed, [out])
    return res


@pytest.mark.parametrize("xs,ys,tx,ty,alpha", MATMULS)
def test_matmul_matches_the_jax_package(xs, ys, tx, ty, alpha):
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(*xs).astype("float32"),
            "y": rng.randn(*ys).astype("float32")}

    def build(fluid):
        x = fluid.layers.data("x", shape=list(xs), append_batch_size=False)
        y = fluid.layers.data("y", shape=list(ys), append_batch_size=False)
        return fluid.layers.matmul(x, y, transpose_x=tx, transpose_y=ty,
                                   alpha=alpha)

    got, want = _forward("torch", build, feed), _forward("jax", build, feed)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


XENTS = [("hard", -100), ("hard", 2), ("soft", -100)]


@pytest.mark.parametrize("kind,ignore", XENTS)
def test_cross_entropy_matches_the_jax_package(kind, ignore):
    rng = np.random.RandomState(4)
    logits = rng.randn(6, 5)
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))
    if kind == "soft":
        lbl = rng.rand(6, 5)
        lbl = (lbl / lbl.sum(-1, keepdims=True)).astype("float32")
    else:
        lbl = rng.randint(0, 5, (6, 1)).astype("int64")
        lbl[0, 0] = 2
    feed = {"p": probs.astype("float32"), "l": lbl}

    def build(fluid):
        p = fluid.layers.data("p", shape=[5])
        lab = fluid.layers.data("l", shape=[5] if kind == "soft" else [1],
                                dtype="float32" if kind == "soft"
                                else "int64")
        return fluid.layers.cross_entropy(p, lab, soft_label=kind == "soft",
                                          ignore_index=ignore)

    got, want = _forward("torch", build, feed), _forward("jax", build, feed)
    assert got.shape == want.shape == (6, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if ignore == 2:
        assert got[0, 0] == 0.0


def test_equal_matches_the_jax_package():
    feed = {"a": np.array([[1, 2, 3], [4, 5, 6]], "int32"),
            "b": np.array([[1, 0, 3], [4, 5, 0]], "int32")}

    def build(fluid):
        a = fluid.layers.data("a", shape=[3], dtype="int32")
        b = fluid.layers.data("b", shape=[3], dtype="int32")
        return fluid.layers.equal(a, b)

    got, want = _forward("torch", build, feed), _forward("jax", build, feed)
    np.testing.assert_array_equal(got, want)


def test_matmul_promotes_mixed_dtypes_as_jnp_does():
    """A float32 activation against bfloat16 operands multiplies in
    float32 (``jnp.matmul``'s promotion); ``mul`` alike."""
    from paddle_tpu_torch.core.registry import OpContext, get_op_impl

    x = torch.randn(2, 3)
    y = torch.randn(3, 4).to(torch.bfloat16)
    main = tfluid.Program()
    op = main.global_block.append_op(
        "matmul", inputs={"X": "x", "Y": "y"}, outputs={"Out": "o"},
        attrs={"alpha": 1.0})
    env = {"x": x, "y": y}
    get_op_impl("matmul")(OpContext(op, env, None))
    assert env["o"].dtype == torch.float32
    torch.testing.assert_close(env["o"], x @ y.float())
