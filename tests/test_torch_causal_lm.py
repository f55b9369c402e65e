"""The port trains the long-context causal LM as the JAX package does.

``causal_lm`` (2 layers, d_model 64, 2 heads, d_inner 128, vocab 211, 128
tokens, batch 2, dropout 0, Adam 1e-3) is built by both packages. The JAX
startup program initialises the weights and ``io.state_from_numpy`` carries
them into the port's scope. On the CPU the JAX package composes its
attention; the port, with ``FLAGS_flash_attention_min_seq`` at 128, takes
its flash route (the kernels' plain versions), so equal losses also hold
flash against composed end to end.

* float32: 3 steps' losses agree to 1e-5 relative (the same arithmetic in
  another summation order).
* bfloat16 AMP (``amp.decorate``): to 2e-2 relative. Both sides keep
  float32 master weights and run the forward in bfloat16, but they round
  at different places (the port's attention sums in float32 and rounds p
  before p·v, XLA's composed softmax is bfloat16 throughout), and the
  fetched loss is itself a bfloat16 number: one step of it at 5.5 is
  0.03, 6e-3 relative, so the tolerance is three such steps. The scope's
  parameters must stay float32 and move.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as jtfm
from paddle_tpu_torch.flags import set_flag
from paddle_tpu_torch.models import transformer as ttfm
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from test_torch_program import ops_of

CFG = dict(vocab_size=211, max_length=128, n_layer=2, n_head=2, d_model=64,
           d_inner=128)
B, S = 2, 128


@pytest.fixture(autouse=True)
def _flash_from_128():
    set_flag("flash_attention_min_seq", 128)
    yield
    set_flag("flash_attention_min_seq", 2048)


def build(fluid, tfm, amp=False, dropout=0.0):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[S], dtype="int64")
        lbl = fluid.layers.data("lbl", shape=[S, 1], dtype="int64")
        _, loss = tfm.causal_lm(ids, lbl, dropout_rate=dropout, **CFG)
        opt = fluid.optimizer.Adam(learning_rate=1e-3)
        if amp:
            opt = fluid.amp.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def feed_batch():
    rng = np.random.RandomState(0)
    return {"ids": rng.randint(0, CFG["vocab_size"], (B, S)).astype("int64"),
            "lbl": rng.randint(0, CFG["vocab_size"],
                               (B, S, 1)).astype("int64")}


def count_flash(fn):
    """fn() with the plain forward counted: the flash route on the CPU."""
    calls = {"n": 0}
    orig = tfa.flash_fwd_reference

    def spy(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    tfa.flash_fwd_reference = spy
    try:
        out = fn()
    finally:
        tfa.flash_fwd_reference = orig
    return out, calls["n"]


def train_both(amp, steps=3):
    feed = feed_batch()
    jm, js, jloss = build(jfluid, jtfm, amp)
    tm, _, tloss = build(tfluid, ttfm, amp)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
        want = [float(jexe.run(jm, feed=feed, fetch_list=[jloss])[0])
                for _ in range(steps)]
    tscope = tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(),
                                        tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    got, flash_calls = count_flash(lambda: [
        float(texe.run(tm, feed=feed, fetch_list=[tloss], scope=tscope)[0])
        for _ in range(steps)])
    assert flash_calls == CFG["n_layer"] * steps
    return got, want, tm, tscope, arrays


def test_causal_lm_program_structure_matches():
    jm, js, jloss = build(jfluid, jtfm, dropout=0.1)
    tm, ts, tloss = build(tfluid, ttfm, dropout=0.1)
    assert tloss.name == jloss.name
    jops, tops = ops_of(jm), ops_of(tm)
    assert [o[0] for o in tops] == [o[0] for o in jops]
    for j, t in zip(jops, tops):
        assert t == j, (t[0], j[0])
    assert "gelu" in {o[0] for o in tops}
    assert {p.name: p.shape for p in tm.all_parameters()} == \
        {p.name: p.shape for p in jm.all_parameters()}
    assert ops_of(ts) == ops_of(js)
    assert tm._backward_info == jm._backward_info
    assert {v.name: v.shape for v in tm.list_vars()} == \
        {v.name: v.shape for v in jm.list_vars()}


def test_float32_losses_match_jax_over_3_adam_steps():
    got, want, _, _, _ = train_both(amp=False)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_amp_losses_match_jax_and_masters_stay_float32():
    got, want, tm, tscope, arrays = train_both(amp=True)
    assert tm._amp_dtype == "bfloat16"
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert got[-1] < got[0]
    moved = 0
    for p in tm.all_parameters():
        val = tscope.find_var(p.name)
        assert val.dtype == torch.float32, p.name
        moved += int(not np.array_equal(val.numpy(), arrays[p.name]))
    assert moved == len(tm.all_parameters())


def test_amp_forward_runs_in_bfloat16_and_eval_keeps_the_state():
    """An eval clone under AMP fetches bfloat16-computed logits and leaves
    the scope's float32 state as it was, bit for bit."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        ids = tfluid.layers.data("ids", shape=[S], dtype="int64")
        lbl = tfluid.layers.data("lbl", shape=[S, 1], dtype="int64")
        logits, loss = ttfm.causal_lm(ids, lbl, dropout_rate=0.0,
                                      is_test=True, **CFG)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    before = {n: scope.as_numpy(n).copy() for n in scope.vars}
    feed = feed_batch()
    f32, = exe.run(main, feed=feed, fetch_list=[logits], scope=scope)
    tfluid.amp.enable(main)
    out, = exe.run(main, feed=feed, fetch_list=[logits], scope=scope,
                   return_numpy=False)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), f32, atol=5e-2, rtol=5e-2)
    assert not np.array_equal(out.float().numpy(), f32)
    for n, a in before.items():
        assert scope.find_var(n).dtype == torch.float32
        np.testing.assert_array_equal(scope.as_numpy(n), a)
    tfluid.amp.disable(main)
    again, = exe.run(main, feed=feed, fetch_list=[logits], scope=scope)
    np.testing.assert_array_equal(again, f32)


def test_amp_api():
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        tfluid.amp.enable(tfluid.Program(), dtype="float64")
    with pytest.raises(NotImplementedError, match="dynamic loss scaling"):
        tfluid.amp.decorate(tfluid.optimizer.Adam(1e-3),
                            use_dynamic_loss_scaling=True)
    opt = tfluid.amp.decorate(tfluid.optimizer.Adam(1e-3),
                              init_loss_scaling=8.0)
    assert opt._learning_rate == 1e-3  # attributes reach the optimizer
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", shape=[4])
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 3))
        opt.minimize(loss)
    types = [op.type for op in main.global_block.ops]
    # the loss is scaled up before the backward, each gradient down after
    marker, adam = types.index("backward_marker"), types.index("adam")
    assert types[:marker].count("scale") == 1
    assert types[marker:adam].count("scale") == len(main.all_parameters())
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    w = main.all_parameters()[0].name
    w0 = scope.as_numpy(w).copy()
    exe.run(main, feed={"x": np.ones((2, 4), "float32")}, fetch_list=[loss],
            scope=scope)
    # Adam's first step moves every weight by about lr, whatever the scale
    assert np.abs(scope.as_numpy(w) - w0).max() < 2e-3


def test_dropout_training_under_amp_runs():
    tm, ts, tloss = build(tfluid, ttfm, amp=True, dropout=0.1)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(ts, scope=scope)
    feed = feed_batch()
    losses = [float(exe.run(tm, feed=feed, fetch_list=[tloss],
                            scope=scope)[0]) for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
