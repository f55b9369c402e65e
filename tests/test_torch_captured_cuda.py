"""The captured step on the card.

``Executor.run_steps`` and ``Executor.run(CompiledProgram)`` warm a step
up eagerly, capture it into a CUDA graph and replay it; these tests hold
the replays against eager ``run()`` steps from the same start state, with
the hand-written kernels (K1 with its dropout seed on the card, K2, K4)
inside the graph, an accumulated step as one graph, the pass
pipeline's rewrites reaching K1 and K2, the weight decay's in-place
``sum`` and LARS's norms inside the graph, and a learning-rate schedule
with the global-norm clip (its counter advanced once a replay), the
rows-only branches of the other sparse optimizers and ``ModelAverage`` on
the card, and the recipe step's reproducibility (BERT at 2 layers under
AMP with AdamW or LAMB and the global-norm clip: two eager runs from one
start bit-equal, captured against eager within 1e-3 in every tensor; the
lookup's table gradient the same on every stream). Every test carries the
``cuda`` marker and skips without a GPU. The file imports neither ``jax``
nor ``paddle_tpu``:

    python -m pytest tests/test_torch_captured_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.executor import WARMUP_STEPS
from paddle_tpu_torch.flags import set_flag
from paddle_tpu_torch.monitor import metrics
from paddle_tpu_torch.ops.kernels import softmax_xent as sx
from paddle_tpu_torch.ops.kernels import sparse_adam as sa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    yield torch.device("cuda")
    set_flag("flash_attention_min_seq", 2048)


def bert_program(amp):
    from paddle_tpu_torch.models import bert

    s, n_mask = 16, 3
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        names = ("ids", "pos", "sent")
        ins = [fluid.layers.data(n, shape=[s], dtype="int64") for n in names]
        mask = fluid.layers.data("mask", shape=[s], dtype="float32")
        mpos = fluid.layers.data("mpos", shape=[n_mask], dtype="int64")
        mlbl = fluid.layers.data("mlbl", shape=[1], dtype="int64")
        nsp = fluid.layers.data("nsp", shape=[1], dtype="int64")
        loss, _, _ = bert.bert_pretrain(*ins, mask, mpos, mlbl, nsp,
                                        dropout_rate=0.1,
                                        **bert.BERT_TINY_CONFIG)
        opt = fluid.optimizer.Adam(1e-3)
        if amp:
            opt = fluid.amp.decorate(opt)
        opt.minimize(loss)
    vocab = bert.BERT_TINY_CONFIG["vocab_size"]
    feeds = []
    for seed in range(6):
        rng = np.random.RandomState(seed)
        feeds.append({
            "ids": rng.randint(0, vocab, (4, s)).astype("int64"),
            "pos": np.tile(np.arange(s), (4, 1)).astype("int64"),
            "sent": rng.randint(0, 2, (4, s)).astype("int64"),
            "mask": (rng.rand(4, s) > 0.2).astype("float32"),
            "mpos": (np.arange(4)[:, None] * s
                     + rng.randint(0, s, (4, n_mask))).astype("int64"),
            "mlbl": rng.randint(0, vocab, (4 * n_mask, 1)).astype("int64"),
            "nsp": rng.randint(0, 2, (4, 1)).astype("int64")})
    return main, startup, loss, feeds


SPARSE_OPTIMIZERS = {
    "adam": lambda: fluid.optimizer.Adam(1e-2),
    "sgd": lambda: fluid.optimizer.SGD(1e-1),
    "momentum": lambda: fluid.optimizer.Momentum(1e-2, 0.9),
    "adagrad": lambda: fluid.optimizer.Adagrad(1e-2),
    "proximal_gd": lambda: fluid.optimizer.ProximalGD(
        1e-1, l1_regularization_strength=1e-4),
    "proximal_adagrad": lambda: fluid.optimizer.ProximalAdagrad(
        1e-2, l1_regularization_strength=1e-4),
}


def deepfm_program(opt):
    from paddle_tpu_torch.models import deepfm

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[8], dtype="int64")
        dense = fluid.layers.data("dense", shape=[13])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        _, loss, _ = deepfm.deepfm(ids, dense, label, sparse_feature_dim=1000,
                                   embedding_size=4, num_fields=8,
                                   layer_sizes=(16, 16))
        SPARSE_OPTIMIZERS[opt]().minimize(loss)
    feeds = []
    for seed in range(6):
        rng = np.random.RandomState(seed)
        feeds.append({"ids": rng.randint(0, 1000, (32, 8)).astype("int64"),
                      "dense": rng.rand(32, 13).astype("float32"),
                      "label": rng.randint(0, 2, (32, 1)).astype("int64")})
    return main, startup, loss, feeds


def eager_and_captured(main, startup, loss, feeds, fetch_every):
    """The same steps from one start state: eager ``run()`` on one scope,
    ``run_steps`` on a copy. Returns (eager losses, captured losses, eager
    scope, captured scope, counter deltas)."""
    dev = fluid.CUDAPlace(0)
    scope_e = fluid.Scope()
    exe = fluid.Executor(dev)
    exe.run(startup, scope=scope_e)
    scope_c = fluid.Scope()
    for n, v in scope_e.vars.items():
        scope_c.set_var(n, v.clone())
    step0 = getattr(main, "_tpu_step_counter", 0)
    want = [float(exe.run(main, feed=f, fetch_list=[loss],
                          scope=scope_e)[0]) for f in feeds]
    main._tpu_step_counter = step0
    caps, reps = metrics.CAPTURES.value, metrics.REPLAYS.value
    exe_c = fluid.Executor(dev)
    rows = exe_c.run_steps(main, feeds, fetch_list=[loss],
                           fetch_every=fetch_every, scope=scope_c)
    counts = (metrics.CAPTURES.value - caps, metrics.REPLAYS.value - reps)
    exe_c.close()
    return want, [float(r[0]) for r in rows], scope_e, scope_c, counts


def assert_state_close(scope_e, scope_c, rtol, atol):
    for n, v in scope_e.vars.items():
        np.testing.assert_allclose(scope_c.as_numpy(n),
                                   v.float().cpu().numpy(), rtol=rtol,
                                   atol=atol, err_msg=n)


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "bf16_amp"])
def test_captured_bert_matches_eager_steps_with_dropout(cuda, amp):
    """bert_tiny at dropout 0.1: the replays give the eager steps' losses
    (each step its own masks), with K2 at both loss shapes in the graph."""
    main, startup, loss, feeds = bert_program(amp)
    f0 = sx.LAUNCHES_FWD
    want, got, scope_e, scope_c, counts = eager_and_captured(
        main, startup, loss, feeds, fetch_every=3)
    assert counts == (1, len(feeds) - WARMUP_STEPS)
    # two loss shapes: 6 eager steps, the warm-ups and the capture
    assert sx.LAUNCHES_FWD - f0 == 2 * (len(feeds) + WARMUP_STEPS + 1)
    tol = 1e-3 if amp else 1e-6
    np.testing.assert_allclose(got, want, rtol=tol)
    if not amp:  # bfloat16 losses may round to the same value
        assert len(set(want)) == len(want)
    assert_state_close(scope_e, scope_c, rtol=tol, atol=tol)


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_captured_deepfm_updates_its_tables_in_graph(cuda, opt):
    """K4a (Adam) or K4b (SGD) update the tables in place inside the
    graph: the captured steps give the eager steps' losses and state."""
    main, startup, loss, feeds = deepfm_program(opt)
    counter = "LAUNCHES_ADAM" if opt == "adam" else "LAUNCHES_SGD"
    k0 = getattr(sa, counter)
    want, got, scope_e, scope_c, counts = eager_and_captured(
        main, startup, loss, feeds, fetch_every=4)
    assert counts == (1, len(feeds) - WARMUP_STEPS)
    assert getattr(sa, counter) - k0 == 2 * (len(feeds) + WARMUP_STEPS + 1)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_state_close(scope_e, scope_c, rtol=1e-4, atol=1e-6)


def test_compiled_program_runs_captured_steps(cuda):
    main, startup, loss, feeds = deepfm_program("adam")
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    prog = fluid.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    reps = metrics.REPLAYS.value
    out = [exe.run(prog, feed=f, fetch_list=[loss], scope=scope)
           for f in feeds]
    assert metrics.REPLAYS.value - reps == len(feeds) - WARMUP_STEPS
    assert all(np.isfinite(o[0]) for o in out)
    (lv,) = exe.run(prog, feed=feeds[0], fetch_list=[loss], scope=scope,
                    return_numpy=False)
    assert lv.is_cuda
    exe.close()
    assert not exe._captured


def test_handles_hold_device_tensors_and_an_event(cuda):
    main, startup, loss, feeds = deepfm_program("sgd")
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    hs = exe.run_steps(main, feeds, fetch_list=[loss], fetch_every=4,
                       scope=scope, return_numpy=False)
    assert [tuple(h.raw[0].shape) for h in hs] == [(4,), (2,)]
    assert hs[0].raw[0].is_cuda
    last = np.asarray(hs[-1][0])
    assert hs[-1].done() and np.isfinite(last).all()
    np.testing.assert_array_equal(hs[0].block().numpy()[0],
                                  np.asarray(hs[0][0]))
    exe.close()


def flash_dropout_program():
    """Two causal encoder layers whose attention takes the flash route
    (S = 128 with ``flash_attention_min_seq`` 128) with attention dropout
    0.1 and no other dropout, trained with SGD."""
    from paddle_tpu_torch.models import transformer as tfm

    set_flag("flash_attention_min_seq", 128)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[128, 64], dtype="float32")
        h = x
        for i in range(2):
            h = tfm.encoder_layer(h, None, 2, 32, 32, 64, 128,
                                  dropout_rate=0.0, attn_dropout=0.1,
                                  causal=True, name="l%d" % i)
        loss = fluid.layers.mean(h)
        fluid.optimizer.SGD(1e-2).minimize(loss)
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(2, 128, 64).astype("float32")}] * 6
    return main, startup, loss, feeds


def test_capture_replays_flash_attention_with_dropout(cuda):
    """The flash route with dropout draws its seed on the card: the step
    captures, its replays give the eager steps' losses (each step its own
    masks, so the same feed gives another loss), and K1a-c run in it."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    main, startup, loss, feeds = flash_dropout_program()
    f0, k0, q0 = fa.LAUNCHES_FWD, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ
    want, got, scope_e, scope_c, counts = eager_and_captured(
        main, startup, loss, feeds, fetch_every=2)
    assert counts == (1, len(feeds) - WARMUP_STEPS)
    n = 2 * (len(feeds) + WARMUP_STEPS + 1)  # two sites a step
    assert (fa.LAUNCHES_FWD - f0, fa.LAUNCHES_DKV - k0,
            fa.LAUNCHES_DQ - q0) == (n, n, n)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert len(set(want)) == len(want)
    assert_state_close(scope_e, scope_c, rtol=1e-5, atol=1e-6)


def test_flash_dropout_step_makes_no_host_sync(cuda):
    """An eager step of the flash-dropout program with its feed on the
    card runs under the sync debug mode's "error"."""
    main, startup, loss, feeds = flash_dropout_program()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = {"x": torch.as_tensor(feeds[0]["x"], device=cuda)}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                return_numpy=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    exe.close()


def eager_accumulated(exe, main, scope, feed, loss, accum):
    """One eager accumulated step (the body a captured accumulated step
    holds), on the pipeline's clone of ``main``; returns the loss."""
    names = (loss.name,)
    step = exe._next_step_index(main)
    prog = exe._maybe_optimize(main, names, scope)
    feeds = {n: exe._feed_tensor(prog.global_block, n, v)
             for n, v in feed.items()}
    env = exe._eager_step(prog, exe._plan(prog), scope, feeds, names, step,
                          accum)
    return float(env[loss.name])


def test_captured_accumulated_step_matches_eager(cuda):
    """An MLP at dropout 0.1 with 4 microbatches a step: one graph holds
    them all; its replays give the eager accumulated steps' losses and
    state (each microbatch its own masks)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[64])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 128, act="relu")
        h = fluid.layers.dropout(h, 0.1,
                                 dropout_implementation="upscale_in_train")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(h, 10), y))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(64, 64).astype("float32"),
              "y": rng.randint(0, 10, (64, 1)).astype("int64")}
             for _ in range(6)]
    dev = fluid.CUDAPlace(0)
    scope_e = fluid.Scope()
    exe = fluid.Executor(dev)
    exe.run(startup, scope=scope_e)
    scope_c = fluid.Scope()
    for n, v in scope_e.vars.items():
        scope_c.set_var(n, v.clone())
    step0 = getattr(main, "_tpu_step_counter", 0)
    f0 = sx.LAUNCHES_FWD
    want = [eager_accumulated(exe, main, scope_e, f, loss, 4) for f in feeds]
    assert sx.LAUNCHES_FWD - f0 == 4 * len(feeds)  # one a microbatch
    main._tpu_step_counter = step0
    bs = fluid.BuildStrategy()
    bs.gradient_accumulation_steps = 4
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs)
    caps = metrics.CAPTURES.value
    exe_c = fluid.Executor(dev)
    rows = exe_c.run_steps(prog, feeds, fetch_list=[loss], fetch_every=3,
                           scope=scope_c)
    assert metrics.CAPTURES.value - caps == 1
    np.testing.assert_allclose([float(r[0]) for r in rows], want, rtol=1e-6)
    assert len(set(want)) == len(want)
    assert_state_close(scope_e, scope_c, rtol=1e-5, atol=1e-6)
    exe_c.close()


@pytest.mark.parametrize("level", ["0", "1"])
def test_softmax_xent_fuse_reaches_k2(cuda, monkeypatch, level):
    """``softmax`` + ``cross_entropy`` launch K2a/K2b once a step at
    PADDLE_TPU_OPT_LEVEL=1 (the fused loss) and never at 0."""
    monkeypatch.setenv("PADDLE_TPU_OPT_LEVEL", level)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[32])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        probs = fluid.layers.fc(x, size=10, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(probs, y))
        acc = fluid.layers.accuracy(probs, y)
        fluid.optimizer.SGD(0.1).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(64, 32).astype("float32"),
            "y": rng.randint(0, 10, (64, 1)).astype("int64")}
    f0, b0 = sx.LAUNCHES_FWD, sx.LAUNCHES_BWD
    out = [exe.run(main, feed=feed, fetch_list=[loss, acc], scope=scope)
           for _ in range(3)]
    want = 3 if level == "1" else 0
    assert (sx.LAUNCHES_FWD - f0, sx.LAUNCHES_BWD - b0) == (want, want)
    assert out[-1][0] < out[0][0]
    exe.close()


def test_flash_attention_rewrite_reaches_k1(cuda):
    """The unfused attention composition at S = 128 (with
    ``flash_attention_min_seq`` 128) is rewritten onto the fused op and
    launches K1a-c once a site a step."""
    from paddle_tpu_torch.layers import attention as attn
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    set_flag("flash_attention_min_seq", 128)
    set_flag("unfused_attention", True)
    main, startup = fluid.Program(), fluid.Program()
    try:
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", shape=[128, 64], dtype="float32")
            seg = fluid.layers.data("seg", shape=[128], dtype="int32")
            h = attn.multi_head_attention(x, None, None, None, 32, 32, 64, 2,
                                          segment_ids_q=seg,
                                          segment_ids_kv=seg)
            loss = fluid.layers.mean(h)
            fluid.optimizer.SGD(1e-2).minimize(loss)
    finally:
        set_flag("unfused_attention", False)
    assert sum(op.type == "matmul" for op in main.global_block.ops) == 2
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(2, 128, 64).astype("float32"),
            "seg": np.ones((2, 128), "int32")}
    f0, k0, q0 = fa.LAUNCHES_FWD, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert (fa.LAUNCHES_FWD - f0, fa.LAUNCHES_DKV - k0,
            fa.LAUNCHES_DQ - q0) == (2, 2, 2)
    exe.close()


def test_capture_names_an_op_that_reads_the_host(cuda):
    """A reshape whose shape comes from a tensor reads it on the host
    (a sync): the capture fails and names that op."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[6], dtype="float32")
        shape = fluid.layers.data("shape", shape=[2], dtype="int32",
                                  append_batch_size=False)
        y = fluid.layers.reshape(x, shape=[-1, 6])
        op = main.global_block.ops[-1]
        op.inputs["Shape"] = [shape.name]
        loss = fluid.layers.mean(y)
    feed = {"x": np.ones((4, 6), "float32"),
            "shape": np.array([2, 12], "int32")}
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with pytest.raises(RuntimeError, match="reshape2"):
        exe.run_steps(main, [feed] * (WARMUP_STEPS + 1), fetch_list=[loss],
                      scope=fluid.Scope())
    exe.close()


def test_accuracy_makes_no_host_copy(cuda):
    """An MNIST MLP step with ``accuracy`` (fetched as a device tensor,
    feeds on the card) runs under the sync debug mode's "error"."""
    from paddle_tpu_torch.models import mnist

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", shape=[784])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        _, loss, acc = mnist.mlp(img, label)
        fluid.optimizer.Momentum(1e-3, 0.9).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"img": torch.as_tensor(rng.rand(64, 784).astype("float32"),
                                   device=cuda),
            "label": torch.as_tensor(rng.randint(0, 10, (64, 1)),
                                     device=cuda)}
    exe.run(main, feed=feed, fetch_list=[loss, acc], scope=scope)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        exe.run(main, feed=feed, fetch_list=[loss, acc], scope=scope,
                return_numpy=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("opt", ["l2decay", "l1decay", "lars"])
def test_captured_weight_decay_and_lars_match_eager(cuda, opt):
    """The weight decay's ``sum`` writes each gradient in place (``Out`` is
    its first input) inside the graph's static buffers; LARS keeps its norms
    and its choice on the card. The replays give the eager steps."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[16])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 32, act="sigmoid")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(h, 4), y))
        if opt == "lars":
            fluid.optimizer.LarsMomentumOptimizer(0.1, 0.9).minimize(loss)
        else:
            decay = (fluid.regularizer.L2Decay if opt == "l2decay"
                     else fluid.regularizer.L1Decay)(1e-2)
            fluid.optimizer.Momentum(0.1, 0.9,
                                     regularization=decay).minimize(loss)
    feeds = []
    for seed in range(6):
        rng = np.random.RandomState(seed)
        feeds.append({"x": rng.randn(8, 16).astype("float32"),
                      "y": rng.randint(0, 4, (8, 1)).astype("int64")})
    want, got, scope_e, scope_c, counts = eager_and_captured(
        main, startup, loss, feeds, fetch_every=6)
    assert counts == (1, len(feeds) - WARMUP_STEPS)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert_state_close(scope_e, scope_c, rtol=1e-6, atol=1e-7)


COUNTER = "@LR_DECAY_COUNTER@"


def scheduled_program(opt):
    """A 2-layer MLP under Devlin's recipe at test size: the nested
    warm-up/decay schedule, the global-norm clip, and AdamW or LAMB."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[16])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 32, act="sigmoid")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(h, 4), y))
        lr = fluid.layers.linear_lr_warmup(
            fluid.layers.polynomial_decay(1e-2, 8, 0.0, 1.0), 2, 0.0, 1e-2)
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(1.0))
        if opt == "adamw":
            fluid.optimizer.AdamW(lr, weight_decay=0.01,
                                  epsilon=1e-6).minimize(loss)
        else:
            fluid.optimizer.Lamb(lr, lamb_weight_decay=0.01).minimize(loss)
    feeds = []
    for seed in range(8):
        rng = np.random.RandomState(seed)
        feeds.append({"x": rng.randn(8, 16).astype("float32"),
                      "y": rng.randint(0, 4, (8, 1)).astype("int64")})
    return main, startup, loss, lr, feeds


@pytest.mark.parametrize("opt", ["adamw", "lamb"])
def test_captured_schedule_advances_the_counter_once_a_replay(cuda, opt):
    """Each replay advances the counter by one from the static state and
    fetches the eager step's rate; an eager ``run()`` after the replays
    sees the advanced counter."""
    main, startup, loss, lr, feeds = scheduled_program(opt)
    dev = fluid.CUDAPlace(0)
    scope_e, scope_c = fluid.Scope(), fluid.Scope()
    exe = fluid.Executor(dev)
    exe.run(startup, scope=scope_e)
    for n, v in scope_e.vars.items():
        scope_c.set_var(n, v.clone())
    want = [[float(np.ravel(a)[0]) for a in exe.run(
        main, feed=f, fetch_list=[loss, lr, COUNTER], scope=scope_e)]
        for f in feeds]
    main._tpu_step_counter = 0
    caps, reps = metrics.CAPTURES.value, metrics.REPLAYS.value
    exe_c = fluid.Executor(dev)
    rows = exe_c.run_steps(main, feeds, fetch_list=[loss, lr, COUNTER],
                           fetch_every=4, scope=scope_c)
    got = [[float(np.ravel(a)[0]) for a in r] for r in rows]
    assert (metrics.CAPTURES.value - caps,
            metrics.REPLAYS.value - reps) == (1, len(feeds) - WARMUP_STEPS)
    assert [r[2] for r in got] == [r[2] for r in want] == list(
        range(len(feeds)))
    assert [r[1] for r in got] == [r[1] for r in want]
    np.testing.assert_allclose([r[0] for r in got], [r[0] for r in want],
                               rtol=1e-6)
    assert int(scope_c.as_numpy(COUNTER)[0]) == len(feeds) - 1
    lv, cv = exe.run(main, feed=feeds[0], fetch_list=[loss, COUNTER],
                     scope=scope_c)
    assert int(np.ravel(cv)[0]) == len(feeds)
    more = exe_c.run_steps(main, feeds[:2], fetch_list=[COUNTER],
                           fetch_every=2, scope=scope_c)
    assert [int(np.ravel(r[0])[0]) for r in more] == [len(feeds) + 1,
                                                      len(feeds) + 2]
    exe_c.close()


def test_scheduled_clipped_step_makes_no_host_sync(cuda):
    main, startup, loss, lr, feeds = scheduled_program("lamb")
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = {k: torch.as_tensor(v, device=cuda) for k, v in feeds[0].items()}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope,
                return_numpy=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    exe.close()


@pytest.mark.parametrize("opt", ["momentum", "adagrad", "proximal_gd",
                                 "proximal_adagrad"])
def test_captured_sparse_branches_match_eager(cuda, opt):
    """The rows-only branches write the tables in place inside the graph:
    the replays give the eager steps' losses and state."""
    main, startup, loss, feeds = deepfm_program(opt)
    want, got, scope_e, scope_c, counts = eager_and_captured(
        main, startup, loss, feeds, fetch_every=4)
    assert counts == (1, len(feeds) - WARMUP_STEPS)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_state_close(scope_e, scope_c, rtol=1e-4, atol=1e-6)


def test_model_average_applies_on_the_card(cuda):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[16])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(x, 4), y))
        fluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
        ma = fluid.optimizer.ModelAverage(0.15, min_average_window=2,
                                          max_average_window=3)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    for _ in range(5):
        exe.run(main, feed={"x": rng.randn(8, 16).astype("float32"),
                            "y": rng.randint(0, 4, (8, 1)).astype("int64")},
                fetch_list=[loss], scope=scope)
    name = main.all_parameters()[0].name
    trained = scope.find_var(name).clone()
    with fluid.scope_guard(scope):
        with ma.apply(exe):
            avg = scope.find_var(name)
            assert avg.is_cuda and avg.dtype == torch.float32
            assert not torch.equal(avg, trained)
        assert torch.equal(scope.find_var(name), trained)


def recipe_bert(opt):
    """BERT at 2 layers of BERT-base's widths under AMP with Devlin's
    recipe (warm-up then decay, the global-norm clip at 1.0, AdamW or
    LAMB), dropout 0.1, on the bench's batch shape (32 x 128, 20 masked):
    every sentence id 0, the 4,096-fold repeated lookup whose table
    gradient once parted between runs."""
    from paddle_tpu_torch.models import bert

    cfg = dict(bert.BERT_BASE_CONFIG, n_layer=2)
    s, n_mask, batch = 128, 20, 32
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        names = ("ids", "pos", "sent")
        ins = [fluid.layers.data(n, shape=[s], dtype="int64") for n in names]
        mask = fluid.layers.data("mask", shape=[s], dtype="float32")
        mpos = fluid.layers.data("mpos", shape=[n_mask], dtype="int64")
        mlbl = fluid.layers.data("mlbl", shape=[1], dtype="int64")
        nsp = fluid.layers.data("nsp", shape=[1], dtype="int64")
        loss, _, _ = bert.bert_pretrain(*ins, mask, mpos, mlbl, nsp, **cfg)
        lr = fluid.layers.linear_lr_warmup(
            fluid.layers.polynomial_decay(1e-4, 8, 0.0, 1.0), 2, 0.0, 1e-4)
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(1.0))
        inner = fluid.optimizer.AdamW(lr, weight_decay=0.01, epsilon=1e-6) \
            if opt == "adamw" else fluid.optimizer.Lamb(
                lr, lamb_weight_decay=0.01)
        fluid.amp.decorate(inner).minimize(loss)
    vocab = cfg["vocab_size"]
    rng = np.random.RandomState(0)
    feed = {
        "ids": rng.randint(0, vocab, (batch, s)).astype("int64"),
        "pos": np.tile(np.arange(s), (batch, 1)).astype("int64"),
        "sent": np.zeros((batch, s), "int64"),
        "mask": np.ones((batch, s), "float32"),
        "mpos": (np.arange(batch)[:, None] * s
                 + rng.randint(0, s, (batch, n_mask))).astype("int64"),
        "mlbl": rng.randint(0, vocab, (batch * n_mask, 1)).astype("int64"),
        "nsp": rng.randint(0, 2, (batch, 1)).astype("int64")}
    return main, startup, loss, [feed] * 6


def largest_tensor_diff(a, b):
    worst = 0.0
    for n, v in a.vars.items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            w = b.find_var(n).double()
            worst = max(worst, float((v.double() - w).norm())
                        / max(float(w.norm()), 1e-30))
    return worst


@pytest.mark.parametrize("opt", ["adamw", "lamb"])
def test_recipe_step_is_reproducible(cuda, opt):
    """Two eager runs of the recipe's steps from one start are bit-equal,
    and the captured steps hold every tensor within the AMP tolerance."""
    main, startup, loss, feeds = recipe_bert(opt)
    dev = fluid.CUDAPlace(0)
    start = fluid.Scope()
    fluid.Executor(dev).run(startup, scope=start)

    def copy():
        out = fluid.Scope()
        for n, v in start.vars.items():
            out.set_var(n, v.clone())
        return out

    runs = []
    for _ in range(2):
        scope = copy()
        main._tpu_step_counter = 0
        exe = fluid.Executor(dev)
        runs.append(([float(exe.run(main, feed=f, fetch_list=[loss],
                                    scope=scope)[0]) for f in feeds], scope))
    (l1, s1), (l2, s2) = runs
    assert l1 == l2
    for n, v in s1.vars.items():
        assert torch.equal(v, s2.find_var(n)), n
    main._tpu_step_counter = 0
    scope_c = copy()
    exe_c = fluid.Executor(dev)
    rows = exe_c.run_steps(main, feeds, fetch_list=[loss], fetch_every=6,
                           scope=scope_c)
    exe_c.close()
    np.testing.assert_allclose([float(r[0]) for r in rows], l1, rtol=1e-3)
    assert largest_tensor_diff(scope_c, s1) <= 1e-3


def test_lookup_table_gradient_is_the_same_on_every_stream(cuda):
    """The dense lookup's table gradient, 4,096 rows into one id and
    16,384 ids into 30,000 rows, in bf16: the same bits on every run and
    on a side stream."""
    from paddle_tpu_torch.ops.nn_ops import _Lookup

    gen = torch.Generator(device="cuda").manual_seed(0)
    side = torch.cuda.Stream()
    for v, n, d, same in ((2, 4096, 768, True), (30000, 16384, 512, False)):
        ids = torch.zeros(n, dtype=torch.long, device="cuda") if same else \
            torch.randint(0, v, (n,), generator=gen, device="cuda")
        w = torch.randn(v, d, generator=gen, device="cuda").bfloat16()
        g = torch.randn(n, d, generator=gen, device="cuda").bfloat16()

        def grad():
            leaf = w.detach().requires_grad_(True)
            return torch.autograd.grad(_Lookup.apply(leaf, ids), leaf, g)[0]

        first = grad()
        assert all(torch.equal(grad(), first) for _ in range(4))
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            again = [grad() for _ in range(4)]
        torch.cuda.current_stream().wait_stream(side)
        assert all(torch.equal(x, first) for x in again)


def test_merge_rows_is_the_same_on_every_stream(cuda):
    """``merge_rows``, the duplicate-id sum before a sparse table's update,
    at word2vec's 400 ids of 2,073 and at 16,384 ids of 1,000: the same
    bits on every run and on a side stream, and the CPU's sum within
    1e-5."""
    from paddle_tpu_torch.core.sparse import merge_rows

    gen = torch.Generator(device="cuda").manual_seed(0)
    side = torch.cuda.Stream()
    for v, n, d in ((2073, 400, 32), (1000, 16384, 16)):
        ids = torch.randint(0, v, (n,), generator=gen, device="cuda")
        rows = torch.randn(n, d, generator=gen, device="cuda")
        uniq, first = merge_rows(ids, rows, v)
        assert all(torch.equal(merge_rows(ids, rows, v)[1], first)
                   for _ in range(4))
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            again = [merge_rows(ids, rows, v)[1] for _ in range(4)]
        torch.cuda.current_stream().wait_stream(side)
        assert all(torch.equal(x, first) for x in again)
        cpu_uniq, cpu = merge_rows(ids.cpu(), rows.cpu(), v)
        assert torch.equal(uniq.cpu(), cpu_uniq)
        torch.testing.assert_close(first.cpu(), cpu, rtol=1e-5, atol=1e-5)


def serving_model(dev):
    from paddle_tpu_torch.models import decoder_lm

    cfg = decoder_lm.DecoderConfig(vocab_size=512, n_layer=2, d_model=64,
                                   n_head=4, max_seq=128)
    return decoder_lm.DecoderLM(cfg, seed=3, device=dev)


def serve_streams(model, dev, graphs, fuse, speculation=0):
    """Half greedy, half sampled requests (the sampled ones top-k 40),
    some with a repeated motif for the drafter."""
    from paddle_tpu_torch import serving

    eng = serving.ServingEngine(model, serving.ServingConfig(
        slots=4, page_size=16, max_seq=128, prompt_buckets=(32, 64),
        decode_fuse=fuse, speculation=speculation, cuda_graphs=graphs),
        device=dev)
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(8):
        p = list(rng.randint(0, 512, 3)) * 5 if i % 3 == 0 \
            else list(rng.randint(0, 512, 10 + 5 * i))
        kw = dict(temperature=1.0, top_k=40, seed=1000 + i) if i % 2 else {}
        reqs.append(eng.submit(p, 12, **kw))
    eng.run()
    assert all(r.state == "finished" for r in reqs)
    assert eng.page_accounting_ok()
    return [r.tokens_out for r in reqs], eng


@pytest.mark.parametrize("fuse,speculation", [(1, 0), (4, 0), (1, 4)])
def test_captured_serving_matches_eager(cuda, fuse, speculation):
    """The decode (and verify) dispatch replayed from CUDA graphs, K3
    inside, gives the eager dispatch's streams bit for bit, and leaves
    K3's arrival counters at zero."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    model = serving_model(cuda)
    eager, _ = serve_streams(model, cuda, False, fuse, speculation)
    got, eng = serve_streams(model, cuda, True, fuse, speculation)
    assert got == eager
    info = eng.graph_info()
    assert any(d["captured"] and d["replays"] > 0 for d in info.values())
    torch.cuda.synchronize()
    assert pa.counters_at_zero()
    eng.close()


def test_threefry_on_the_card_equals_the_cpu(cuda):
    from paddle_tpu_torch.core import threefry as tf

    seeds = torch.arange(1000, 1016, dtype=torch.int32)
    pos = torch.arange(16, dtype=torch.int32) * 37
    want = tf.random_bits(tf.fold_in(tf.prng_key(seeds), pos), 50257)
    got = tf.random_bits(tf.fold_in(tf.prng_key(seeds.to(cuda)),
                                    pos.to(cuda)), 50257)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(tf.uniform(tf.prng_key(seeds.to(cuda)), 999).cpu(),
                       tf.uniform(tf.prng_key(seeds), 999))


def test_serving_capture_names_the_dispatch(cuda):
    """A decode body that reads the card on the host cannot be captured:
    the capture raises naming the dispatch, and it is not run eagerly in
    its place nor absorbed as a failed batch."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.serving.captured import CaptureError

    model = serving_model(cuda)
    eng = serving.ServingEngine(model, serving.ServingConfig(
        slots=2, page_size=16, max_seq=128, prompt_buckets=(32,)),
        device=cuda)
    real = model.decode

    def reads_host(cache, ops, tokens, pos, active):
        int(pos.max())
        return real(cache, ops, tokens, pos, active)

    model.decode = reads_host
    eng.submit([1, 2, 3, 4], 8)
    with pytest.raises(CaptureError, match=r"decode\(width=1, greedy\)"):
        eng.run()
