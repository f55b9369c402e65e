"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports neither ``jax`` nor ``paddle_tpu``, so it runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import serving
from paddle_tpu_torch.flags import set_flag
from paddle_tpu_torch.models import decoder_lm
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.ops.kernels import softmax_xent as sx
from paddle_tpu_torch.serving import kv_cache

SLOTS, H, D, PS, PPS, NUM_PAGES = 5, 2, 16, 8, 8, 24
SM = 1.0 / D ** 0.5
CTX = [1, 7, 8, 33, 64]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    yield torch.device("cuda")
    set_flag("paged_attention_kernel", "auto")


def make_pool(seed, dev):
    rng = np.random.RandomState(seed)
    perm = rng.permutation(NUM_PAGES)
    pt = np.stack([np.resize(perm[s::SLOTS], PPS) for s in range(SLOTS)])

    def t(a):
        return torch.as_tensor(a, device=dev)

    return (t(rng.randn(SLOTS, H, D).astype(np.float32)),
            t(rng.randn(NUM_PAGES * PS, H, D).astype(np.float32)),
            t(rng.randn(NUM_PAGES * PS, H, D).astype(np.float32)),
            t(pt.astype(np.int32)))


def test_kernel_matches_plain_version(cuda):
    """float32 at 1e-5; bf16 pools at 2e-2 against the plain version in
    float32 on the same bf16 values."""
    q, k, v, pt = make_pool(0, cuda)
    ctx = torch.as_tensor(CTX, dtype=torch.int32, device=cuda)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        before = pa.LAUNCHES
        got = pa.paged_decode_attention(qd, kd, vd, pt, ctx, page_size=PS,
                                        sm_scale=SM)
        torch.cuda.synchronize()
        assert pa.LAUNCHES == before + 1
        want = pa.gather_reference(qd.float(), kd.float(), vd.float(), pt,
                                   ctx, PS, sm_scale=SM)
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


def test_garbage_beyond_ctx_len_moves_no_output_bit(cuda):
    q, k, v, pt = make_pool(1, cuda)
    ctx = torch.as_tensor(CTX, dtype=torch.int32, device=cuda)
    rows = (pt.long() * PS)[:, :, None] + torch.arange(PS, device=cuda)
    rows = rows.reshape(SLOTS, -1)
    live = torch.zeros(NUM_PAGES * PS, dtype=torch.bool, device=cuda)
    for s in range(SLOTS):
        live[rows[s, :CTX[s]]] = True
    k_bad, v_bad = k.clone(), v.clone()
    k_bad[~live] = 1e4
    v_bad[~live] = -1e4
    clean = pa.paged_decode_attention(q, k, v, pt, ctx, page_size=PS,
                                      sm_scale=SM)
    bad = pa.paged_decode_attention(q, k_bad, v_bad, pt, ctx, page_size=PS,
                                    sm_scale=SM)
    assert torch.equal(clean, bad)


def test_decode_verify_pseudo_slots_match_gather(cuda):
    _, k, v, pt = make_pool(2, cuda)
    qw = torch.randn(SLOTS, 3, H, D, generator=torch.Generator().manual_seed(0)
                     ).to(cuda)
    ctx = torch.as_tensor([1, 7, 8, 33, 60], dtype=torch.int32, device=cuda)
    cache = kv_cache.PagedKVCache(1, H, D, SLOTS, PPS * PS, PS, NUM_PAGES,
                                  device=cuda)
    state = cache.init_state()
    state["k"][0, :NUM_PAGES * PS] = k
    state["v"][0, :NUM_PAGES * PS] = v
    state["pt"][:] = pt
    before = pa.LAUNCHES
    got = cache.decode_verify(state, 0, qw, ctx, sm_scale=SM)
    assert pa.LAUNCHES == before + 1
    set_flag("paged_attention_kernel", "off")
    want = cache.decode_verify(state, 0, qw, ctx, sm_scale=SM)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_engine_decodes_through_the_kernel(cuda):
    cfg = decoder_lm.DecoderConfig(vocab_size=64, n_layer=2, d_model=32,
                                   n_head=2, max_seq=64)
    model = decoder_lm.DecoderLM(cfg, seed=0)
    rng = np.random.RandomState(0)
    stream = [(rng.randint(0, 64, int(rng.randint(3, 17))).tolist(),
               int(rng.randint(2, 9))) for _ in range(8)]
    outs = []
    for flag in ("auto", "off"):
        set_flag("paged_attention_kernel", flag)
        eng = serving.ServingEngine(model, serving.ServingConfig(
            slots=4, page_size=8, max_seq=64, prompt_buckets=(16,)))
        before = pa.LAUNCHES
        reqs = [eng.submit(p, m) for p, m in stream]
        eng.run()
        launched = pa.LAUNCHES - before
        assert launched == (cfg.n_layer * eng.decode_steps
                            if flag == "auto" else 0)
        assert eng.page_accounting_ok()
        outs.append([r.tokens_out for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("n,v", [(37, 1000), (64, 30000), (5, 7)])
@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_softmax_xent_kernels_match_plain_version(cuda, n, v, smooth):
    """K2a/K2b against the plain version on the same tensors: the loss to
    1e-5 relative in both dtypes (bf16 upcasts exactly); dlogits to 1e-6
    absolute in float32, and in bf16 each element to 2e-2·|want| +
    1e-6·(max |want| of its row), which dlogits without the eps/V term
    break. Ragged V (no multiple of the block), rows labelled -100
    zeroed."""
    rng = np.random.RandomState(n + v)
    x32 = torch.as_tensor((rng.randn(n, v) * 3).astype(np.float32),
                          device=cuda)
    lab_np = rng.randint(0, v, n).astype(np.int64)
    lab_np[::4] = -100
    lab = torch.as_tensor(lab_np, device=cuda)
    keep = (lab != -100)[:, None]
    g = torch.as_tensor(rng.randn(n, 1).astype(np.float32), device=cuda)

    def scaled_err(got, want):
        floor = (1e-6 * want.abs().amax(dim=-1, keepdim=True)).clamp_min(
            1e-30)
        return float(((got.float() - want).abs()
                      / (2e-2 * want.abs() + floor)).max())

    for dt in (torch.float32, torch.bfloat16):
        x = x32.to(dt)
        f0, b0 = sx.LAUNCHES_FWD, sx.LAUNCHES_BWD
        loss, lse = sx.softmax_xent_fwd(x, lab, smooth)
        dx = sx.softmax_xent_bwd(x, lab, lse, g, smooth)
        torch.cuda.synchronize()
        assert (sx.LAUNCHES_FWD, sx.LAUNCHES_BWD) == (f0 + 1, b0 + 1)
        assert dx.dtype == dt
        want_loss, want_lse = sx.softmax_xent_reference(x.float(), lab,
                                                        smooth)
        want_dx = sx.softmax_xent_reference_bwd(x.float(), lab, want_lse,
                                                g, smooth)
        torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-5)
        if dt == torch.float32:
            torch.testing.assert_close(dx, want_dx, rtol=0, atol=1e-6)
        else:
            assert scaled_err(dx, want_dx) <= 1
            if smooth:
                no_eps = torch.where(keep, want_dx + g * (smooth / v), 0.0)
                assert scaled_err(no_eps.to(dt), want_dx) > 1
        assert not loss[::4].any() and not dx[::4].any()


def test_softmax_xent_op_trains_through_the_kernels(cuda):
    """A small program's loss op launches K2a once and K2b once a step."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[16])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        logits = fluid.layers.fc(x, 300)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits, y, label_smoothing=0.1))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(32, 16).astype("float32"),
            "y": rng.randint(0, 300, (32, 1)).astype("int64")}
    f0, b0 = sx.LAUNCHES_FWD, sx.LAUNCHES_BWD
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(5)]
    assert (sx.LAUNCHES_FWD - f0, sx.LAUNCHES_BWD - b0) == (5, 5)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
