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
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.ops.kernels import softmax_xent as sx
from paddle_tpu_torch.ops.kernels import sparse_adam as sa
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
    set_flag("flash_attention_min_seq", 2048)


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


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_kernel_splits_long_contexts(cuda, dt):
    """Slots of several chunks (CHUNK_ROWS rows each): the kernel against
    its plain version and its chunked plain version, two launches
    bit-equal, the arrival counters back at 0 after each, other chunk sizes
    through the same launch, and a slot with no live row giving 0."""
    rng = np.random.RandomState(3)
    b, h, d, ps, pps = 4, 3, 64, 16, 16
    rows = pps * ps
    pt = torch.as_tensor(np.stack([rng.permutation(b * pps)[s::b]
                                   for s in range(b)]).astype(np.int32),
                         device=cuda)
    ctx = torch.as_tensor([0, 1, rows, pa.CHUNK_ROWS + 3], dtype=torch.int32,
                          device=cuda)

    def t(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device=cuda).to(dt)

    q, k, v = t(b, h, d), t(b * pps * ps, h, d), t(b * pps * ps, h, d)
    tol = 1e-5 if dt == torch.float32 else 2e-2
    got = pa.paged_decode_attention(q, k, v, pt, ctx, page_size=ps,
                                    sm_scale=d ** -0.5)
    again = pa.paged_decode_attention(q, k, v, pt, ctx, page_size=ps,
                                      sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and not got[0].any()
    assert not any(c.any() for c in pa._counters.values())
    want = pa.gather_reference(q.float(), k.float(), v.float(), pt, ctx, ps,
                               sm_scale=d ** -0.5)
    chunked = pa.chunked_reference(q.float(), k.float(), v.float(), pt, ctx,
                                   ps, d ** -0.5)
    torch.testing.assert_close(got[1:].float(), want[1:], atol=tol, rtol=tol)
    torch.testing.assert_close(got.float(), chunked, atol=tol, rtol=tol)
    for chunk_rows in (16, 100, rows):
        other = pa._launch(q, k, v, pt, ctx, ps, d ** -0.5, chunk_rows)
        torch.testing.assert_close(other.float(), chunked, atol=tol,
                                   rtol=tol)


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
    # eager dispatches: every K3 launch is counted on the host; the
    # engine's default, the decode graph, launches K3 on the host only in
    # its warm-up and capture, and its stream is the same
    for flag, graphs in (("auto", False), ("off", False), ("auto", True)):
        set_flag("paged_attention_kernel", flag)
        eng = serving.ServingEngine(model, serving.ServingConfig(
            slots=4, page_size=8, max_seq=64, prompt_buckets=(16,),
            cuda_graphs=graphs))
        before = pa.LAUNCHES
        reqs = [eng.submit(p, m) for p, m in stream]
        eng.run()
        launched = pa.LAUNCHES - before
        if graphs:
            assert 0 < launched < cfg.n_layer * eng.decode_steps
        else:
            assert launched == (cfg.n_layer * eng.decode_steps
                                if flag == "auto" else 0)
        assert eng.page_accounting_ok()
        outs.append([r.tokens_out for r in reqs])
    set_flag("paged_attention_kernel", "auto")
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("n,v", [(37, 1000), (64, 30000), (5, 7), (64, 1000),
                                 (64, 10)])
@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_softmax_xent_kernels_match_plain_version(cuda, n, v, smooth):
    """K2a/K2b against the plain version on the same tensors: the loss to
    1e-5 relative in both dtypes (bf16 upcasts exactly); dlogits to 1e-6
    absolute in float32, and in bf16 each element to 2e-2·|want| +
    1e-6·(max |want| of its row), which dlogits without the eps/V term
    break. Ragged V (no multiple of the block), rows labelled -100
    zeroed. [64, 1000] is ResNet-50's loss (float32 and bf16 under AMP),
    [64, 10] the MNIST models'."""
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


def flash_inputs(dev, dt, b, h, sq, sk, d, bias, seg, seed=0, ab_dtype=None):
    """q, k, v, do as transposed views of [B,S,H,D] tensors (the layout the
    attention layer hands over), a bias broadcast over heads (of dtype
    ``ab_dtype``, q's by default), sorted segment ids."""
    rng = np.random.RandomState(seed)

    def t(s):
        x = torch.as_tensor(rng.randn(b, s, h, d).astype(np.float32),
                            device=dev)
        return x.to(dt).transpose(1, 2)

    q, k, v, do = t(sq), t(sk), t(sk), t(sq)
    ab = None
    if bias:
        ab = torch.as_tensor(rng.randn(b, 1, sq, sk).astype(np.float32),
                             device=dev).to(ab_dtype or dt).expand(
                                 b, h, sq, sk)
    ids = None
    if seg:
        ids = fa.SegmentIds(
            torch.as_tensor(np.sort(rng.randint(0, 3, (b, sq))), device=dev),
            torch.as_tensor(np.sort(rng.randint(0, 3, (b, sk))), device=dev))
    return q, k, v, do, ab, ids


FLASH_CASES = [
    # b, h, sq, sk, d, causal, bias, seg, rate
    (2, 3, 256, 256, 64, True, False, False, 0.0),
    (2, 2, 200, 200, 64, True, True, True, 0.0),
    (1, 2, 70, 333, 32, False, True, True, 0.0),
    (1, 2, 333, 70, 128, False, False, False, 0.0),
    (2, 2, 192, 192, 64, True, False, False, 0.1),
    (1, 2, 100, 130, 32, False, False, False, 0.5),
    (1, 1, 130, 130, 128, True, True, False, 0.0),
]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,sk,d,causal,bias,seg,rate", FLASH_CASES)
def test_flash_kernels_match_plain_versions(cuda, dt, b, h, sq, sk, d, causal,
                                            bias, seg, rate):
    """K1a/K1b/K1c against their plain versions on the same tensors:
    float32 to 2e-5 (another summation order), bfloat16 to 2e-2 (outputs
    rounded to bf16; p is rounded against a running maximum in the kernel
    and against the final one in the plain version)."""
    q, k, v, do, ab, ids = flash_inputs(cuda, dt, b, h, sq, sk, d, bias, seg)
    sm, seed = d ** -0.5, 12345
    tol = 2e-5 if dt == torch.float32 else 2e-2
    n0 = (fa.LAUNCHES_FWD, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ)
    o, lse = fa.flash_fwd(q, k, v, ab, ids, causal, sm, rate, seed)
    want_o, want_lse = fa.flash_fwd_reference(q, k, v, ab, ids, causal, sm,
                                              rate, seed)
    torch.testing.assert_close(o.float(), want_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=1e-5)
    assert h == 1 or o.stride() == q.stride()  # no copy on the way back
    # both backward kernels from the plain forward's residuals
    di = (want_o.float() * do.float()).sum(-1)
    args = (q, k, v, ab, ids, want_lse, do, di, causal, sm, rate, seed)
    dk, dv = fa.flash_bwd_dkv(*args)
    dq, dab = fa.flash_bwd_dq(*args)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_FWD - n0[0], fa.LAUNCHES_DKV - n0[1],
            fa.LAUNCHES_DQ - n0[2]) == (1, 1, 1)
    want_dk, want_dv = fa.flash_bwd_dkv_reference(*args)
    want_dq, want_dab = fa.flash_bwd_dq_reference(*args)
    for name, got, want in (("dk", dk, want_dk), ("dv", dv, want_dv),
                            ("dq", dq, want_dq)):
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol, msg=lambda m: name + ": " + m)
    if bias:
        torch.testing.assert_close(dab.float(), want_dab.float(), atol=tol,
                                   rtol=tol)
        dq2, none = fa.flash_bwd_dq(*args, need_dab=False)
        assert none is None and torch.equal(dq2, dq)
    else:
        assert dab is None


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_dropout_mask_is_the_plain_versions(cuda, dt):
    """With v = identity columns the forward's output is the dropped
    probabilities themselves: exactly 0 where the plain mask drops, and
    nowhere else."""
    b, h, s, d = 2, 2, 128, 128
    rng = np.random.RandomState(0)
    q, k = (torch.as_tensor(rng.randn(b, h, s, d).astype(np.float32),
                            device=cuda).to(dt) for _ in range(2))
    v = torch.eye(s, d, device=cuda, dtype=dt).expand(b, h, s, d).contiguous()
    for rate, seed in ((0.1, 7), (0.5, -3), (0.9, 2 ** 31 - 1)):
        o, _ = fa.flash_fwd(q, k, v, None, None, False, 0.05, rate, seed)
        keep = fa.dropout_keep_mask(
            rate, seed,
            torch.arange(b, device=cuda)[:, None, None, None],
            torch.arange(h, device=cuda)[None, :, None, None], 0, 0, (s, s),
            cuda)
        assert torch.equal(o != 0, keep)


def check_flash_kernels(q, k, v, do, ab, ids, causal, rate=0.0, seed=0):
    """K1a, K1b and K1c against their plain versions on the same tensors:
    in bfloat16 (the tensor-core kernels) o, dk, dv, dq and dab to 2e-2
    (bf16 outputs; p and ds rounded to bf16 before their products), in
    float32 (the FFMA tile kernels) to 2e-5 (another summation order); lse
    to 2e-5 + 1e-5 relative, the same rows dead; dab in the bias's dtype.
    Returns the kernels' (o, lse, dk, dv, dq, dab)."""
    sm = q.shape[-1] ** -0.5
    tol = 2e-5 if q.dtype == torch.float32 else 2e-2
    n0 = (fa.LAUNCHES_FWD, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ)
    o, lse = fa.flash_fwd(q, k, v, ab, ids, causal, sm, rate, seed)
    want_o, want_lse = fa.flash_fwd_reference(q, k, v, ab, ids, causal, sm,
                                              rate, seed)
    di = (want_o.float() * do.float()).sum(-1)
    args = (q, k, v, ab, ids, want_lse, do, di, causal, sm, rate, seed)
    dk, dv = fa.flash_bwd_dkv(*args)
    dq, dab = fa.flash_bwd_dq(*args)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_FWD - n0[0], fa.LAUNCHES_DKV - n0[1],
            fa.LAUNCHES_DQ - n0[2]) == (1, 1, 1)
    want_dk, want_dv = fa.flash_bwd_dkv_reference(*args)
    want_dq, want_dab = fa.flash_bwd_dq_reference(*args)
    live = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), live)
    torch.testing.assert_close(lse[live], want_lse[live], atol=2e-5,
                               rtol=1e-5)
    pairs = [("o", o, want_o), ("dk", dk, want_dk), ("dv", dv, want_dv),
             ("dq", dq, want_dq)]
    if ab is not None:
        pairs.append(("dab", dab, want_dab))
    for name, got, want in pairs:
        assert got.dtype == (ab.dtype if name == "dab" else q.dtype)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol, msg=lambda m: name + ": " + m)
    return o, lse, dk, dv, dq, dab


LENS = (1, 63, 64, 65, 127, 129)  # about the 64-column kv tile
RAGGED_SHAPES = [(s, s) for s in LENS] + [(1, 129), (129, 1), (63, 65),
                                          (65, 127), (127, 64), (129, 63)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("sq,sk", RAGGED_SHAPES)
def test_flash_kernels_at_ragged_lengths(cuda, sq, sk, d, dt):
    """Any Sq and Sk about a tile edge, both head widths the main path does
    not take; causal too where Sq == Sk."""
    for causal in ((False, True) if sq == sk else (False,)):
        q, k, v, do, _, _ = flash_inputs(cuda, dt, 2, 2, sq, sk, d, False,
                                         False, seed=sq * 997 + sk)
        check_flash_kernels(q, k, v, do, None, None, causal)


@pytest.mark.parametrize("b,h,sq,sk,d,causal,seg", [
    (2, 2, 200, 200, 64, True, True), (1, 2, 70, 333, 32, False, False),
    (1, 2, 129, 63, 128, False, True), (1, 1, 130, 130, 128, True, False)])
def test_bf16_kernels_read_a_float32_bias(cuda, b, h, sq, sk, d, causal, seg):
    """A float32 bias under bfloat16 q, k, v, read as float32 by all three
    kernels as by their plain versions; K1c returns dab in float32."""
    x = flash_inputs(cuda, torch.bfloat16, b, h, sq, sk, d, True, seg,
                     seed=sq + sk, ab_dtype=torch.float32)
    *_, dab = check_flash_kernels(*x, causal)
    assert dab.dtype == torch.float32


@pytest.mark.parametrize("dt", DTYPES)
def test_flash_kernels_with_a_row_that_sees_nothing(cuda, dt):
    """Segment ids: rows 0..9 see no position, so o = 0, lse = +inf and
    dq = 0 there, and kv rows 50..99 of segment 2 get their gradients from
    q rows 60..99 alone; the other rows match the plain version."""
    q, k, v, do, _, _ = flash_inputs(cuda, dt, 1, 2, 100, 100, 64, False,
                                     False, seed=5)
    ids = fa.SegmentIds(torch.zeros(1, 100, dtype=torch.int64, device=cuda),
                        torch.ones(1, 100, dtype=torch.int64, device=cuda))
    ids.q[0, 10:] = 1
    ids.q[0, 60:] = 2
    ids.kv[0, 50:] = 2
    o, lse, dk, dv, dq, _ = check_flash_kernels(q, k, v, do, None, ids, False)
    assert not o[:, :, :10].any() and bool(torch.isinf(lse[:, :, :10]).all())
    assert not dq[:, :, :10].any() and bool(torch.isfinite(dq).all())
    assert bool(torch.isfinite(dk).all()) and bool(torch.isfinite(dv).all())
    assert bool(torch.isfinite(lse[:, :, 10:]).all())


@pytest.mark.parametrize("dt", DTYPES)
def test_unaligned_view_takes_the_copy(cuda, dt):
    """A q view one element off 16 bytes goes to the kernels, which copy by
    cp.async, as an aligned copy, with the copy's results; the launch itself
    refuses the view: in the forward and in K1b in bfloat16, in the forward,
    K1b and K1c in float32."""
    b, h, s, d = 1, 2, 96, 64
    q, k, v, do, _, _ = flash_inputs(cuda, dt, b, h, s, s, d, False, False,
                                     seed=8)
    flat = torch.empty(b * h * s * d + 1, dtype=dt, device=cuda)
    q_off = flat[1:].view(b, h, s, d)
    q_off.copy_(q)
    assert not fa._cp_async_ok(q_off) and fa._cp_async_ok(q)
    got = check_flash_kernels(q_off, k, v, do, None, None, True)
    want = check_flash_kernels(q, k, v, do, None, None, True)
    for name, a, a_al in zip(("o", "lse", "dk", "dv", "dq"), got, want):
        assert torch.equal(a, a_al), name
    lse = torch.empty(b, h, s, device=cuda)
    with pytest.raises(RuntimeError, match="cudaError_t 716"):
        fa._launch(0, q_off, k, v, None, (None, None), True, 0.125, 0.0, 0,
                   o=torch.empty_like(q_off), lse=lse)
    bwd = dict(lse=lse, dout=do, di=torch.zeros_like(lse))
    k1b = (1, dict(dk=torch.empty_like(k), dv=torch.empty_like(v)))
    k1c = (2, dict(dq=torch.empty_like(q)))
    for which, outs in ((k1b, k1c) if dt == torch.float32 else (k1b,)):
        with pytest.raises(RuntimeError, match="cudaError_t 716"):
            fa._launch(which, q_off, k, v, None, (None, None), True, 0.125,
                       0.0, 0, **bwd, **outs)


def test_flash_dead_rows_and_wrapper_rules(cuda):
    q, k, v, do, _, _ = flash_inputs(cuda, torch.float32, 1, 2, 64, 64, 32,
                                     False, False)
    ids = fa.SegmentIds(torch.zeros(1, 64, dtype=torch.int64, device=cuda),
                        torch.ones(1, 64, dtype=torch.int64, device=cuda))
    ids.q[0, 10:] = 1  # rows 0..9 see nothing
    o, lse = fa.flash_fwd(q, k, v, None, ids)
    assert not o[:, :, :10].any() and bool(torch.isinf(lse[:, :, :10]).all())
    want_o, want_lse = fa.flash_fwd_reference(q, k, v, None, ids)
    torch.testing.assert_close(o, want_o, atol=2e-5, rtol=2e-5)
    di = (o * do).sum(-1)
    dq, _ = fa.flash_bwd_dq(q, k, v, None, ids, lse, do, di)
    assert not dq[:, :, :10].any() and bool(torch.isfinite(dq).all())
    with pytest.raises(ValueError, match="head widths"):
        fa.flash_fwd(q[..., :24], k[..., :24], v[..., :24])
    with pytest.raises(TypeError, match="flash kernels take"):
        fa.flash_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="unit last stride"):
        fa.flash_fwd(*(t.transpose(2, 3)[:, :, :32] for t in (q, k, v)))


def test_causal_lm_attention_trains_through_the_flash_kernels(cuda):
    """A small causal LM with the flag at its sequence length launches
    K1a, K1b and K1c once a layer a step."""
    from paddle_tpu_torch.models import transformer as tfm

    set_flag("flash_attention_min_seq", 128)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[128], dtype="int64")
        lbl = fluid.layers.data("lbl", shape=[128, 1], dtype="int64")
        _, loss = tfm.causal_lm(ids, lbl, vocab_size=211, max_length=128,
                                n_layer=2, n_head=2, d_model=64, d_inner=128,
                                dropout_rate=0.0)
        fluid.optimizer.Adam(1e-3).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(0, 211, (2, 128)).astype("int64"),
            "lbl": rng.randint(0, 211, (2, 128, 1)).astype("int64")}
    n0 = (fa.LAUNCHES_FWD, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(5)]
    assert (fa.LAUNCHES_FWD - n0[0], fa.LAUNCHES_DKV - n0[1],
            fa.LAUNCHES_DQ - n0[2]) == (10, 10, 10)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def sparse_case(dev, vocab, d, n, seed):
    """Tables with nonzero moments, ids with duplicates and a padding id
    (the lookup's id for an id < 0), merged as the optimizer ops merge
    them; row V-1 is named only by the clamped padding ids."""
    from paddle_tpu_torch.core.sparse import merge_rows

    rng = np.random.RandomState(seed)

    def t(a):
        return torch.as_tensor(a, device=dev)

    raw = rng.randint(0, vocab - 1, n).astype(np.int64)
    raw[: n // 4] = raw[n // 4: 2 * (n // 4)]
    raw[-1] = vocab  # a padding id from the lookup (an id < 0 there)
    p = t(rng.randn(vocab, d).astype(np.float32))
    m = t((rng.randn(vocab, d) * 0.1).astype(np.float32))
    v = t((np.abs(rng.randn(vocab, d)) * 0.01).astype(np.float32))
    uniq, merged = merge_rows(t(raw), t(rng.randn(n, d).astype(np.float32)),
                              vocab)
    return (p, m, v), uniq, merged


def sparse_held(tables, uniq, merged, lr_t, vocab):
    """K4a and K4b on ``tables`` (left as they were) against their plain
    versions: every element within 1e-6 of the larger of its values before
    and after (the plain version stores m + (m_new - m) where the kernel
    stores m_new), K4b bit-equal, untouched rows bit-equal."""
    p, m, v = tables
    touched = torch.zeros(vocab, dtype=torch.bool, device=p.device)
    touched[uniq[uniq < vocab]] = True
    want = sa.sparse_adam_rows_reference(p.clone(), m.clone(), v.clone(),
                                         uniq, merged, lr_t)
    want_sgd = sa.sparse_sgd_rows_reference(p.clone(), uniq, merged, lr_t)
    olds = [t.clone() for t in tables]
    got = sa.sparse_adam_rows(p, m, v, uniq, merged, lr_t)
    torch.cuda.synchronize()
    for g, w, old in zip(got, want, olds):
        scale = torch.maximum(w.abs(), old.abs()).clamp_min(1e-30)
        assert float(((g - w).abs() / scale).max()) <= 1e-6
        assert torch.equal(g[~touched].view(torch.int32),
                           old[~touched].view(torch.int32))
    got_sgd = sa.sparse_sgd_rows(olds[0], uniq, merged, lr_t)
    torch.cuda.synchronize()
    assert torch.equal(got_sgd.view(torch.int32), want_sgd.view(torch.int32))
    return touched


def off_by(t, elems):
    """A contiguous copy of ``t`` whose storage starts ``elems`` elements
    into a fresh buffer: 4 * elems bytes off 16-byte alignment for
    float32, 8 * elems for int64."""
    flat = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    return flat[elems:].view(t.shape).copy_(t)


# D = 10 (8 lanes of float2 a row) and 1 (one thread a row), DeepFM's
# widths, and for the other lane counts and vector widths: 2 (float2), 4,
# 16 and 64 (float4), 7 and 33 (scalar; 33 needs two passes of 32 lanes)
SPARSE_CASES = [(1000, 10, 300), (5000, 1, 700), (64, 7, 200),
                (3000, 2, 500), (2000, 4, 400), (1500, 16, 300),
                (900, 33, 257), (700, 64, 200)]


@pytest.mark.parametrize("vocab,d,n", SPARSE_CASES)
def test_sparse_row_kernels_match_plain_versions(cuda, vocab, d, n):
    """K4a and K4b against their plain versions on the same merged rows:
    every element within 1e-6 of the larger of its values before and after
    (the plain version stores m + (m_new - m) where the kernel stores
    m_new), untouched rows bit-equal, row V-1 included, which only a
    padding id clamps to."""
    (p, m, v), uniq, merged = sparse_case(cuda, vocab, d, n, vocab + d)
    want_width = 4 if d % 4 == 0 else 2 if d % 2 == 0 else 1
    assert sa.load_width((p, m, v), merged) == want_width
    lr_t = torch.tensor([3e-3], device=cuda)
    touched = torch.zeros(vocab, dtype=torch.bool, device=cuda)
    touched[uniq[uniq < vocab]] = True
    assert not touched[vocab - 1]
    a0 = sa.LAUNCHES_ADAM
    got = sa.sparse_adam_rows(p.clone(), m.clone(), v.clone(), uniq, merged,
                              lr_t)
    want = sa.sparse_adam_rows_reference(p.clone(), m.clone(), v.clone(),
                                         uniq, merged, lr_t)
    torch.cuda.synchronize()
    assert sa.LAUNCHES_ADAM == a0 + 1
    for g, w, old in zip(got, want, (p, m, v)):
        scale = torch.maximum(w.abs(), old.abs()).clamp_min(1e-30)
        assert float(((g - w).abs() / scale).max()) <= 1e-6
        assert torch.equal(g[~touched], old[~touched])
        assert not torch.equal(g[touched], old[touched])
    s0 = sa.LAUNCHES_SGD
    got = sa.sparse_sgd_rows(p.clone(), uniq, merged, lr_t)
    want = sa.sparse_sgd_rows_reference(p.clone(), uniq, merged, lr_t)
    torch.cuda.synchronize()
    assert sa.LAUNCHES_SGD == s0 + 1
    assert torch.equal(got, want)
    assert torch.equal(got[~touched], p[~touched])


@pytest.mark.parametrize("d", [10, 1, 4, 16])
@pytest.mark.parametrize("tab_off,in_off", [(1, 0), (2, 0), (0, 1), (3, 1)])
def test_sparse_row_kernels_take_views_off_alignment(cuda, d, tab_off,
                                                     in_off):
    """Contiguous table, id and row views whose storage offsets break 8- or
    16-byte alignment take a narrower instantiation of the same kernel
    (never the plain version) and give the same result."""
    vocab, n = 1200, 400
    tables, uniq, merged = sparse_case(cuda, vocab, d, n, d + tab_off)
    tables = [off_by(t, tab_off) for t in tables]
    uniq, merged = off_by(uniq, in_off), off_by(merged, in_off)
    # fresh buffers lie on 256 bytes: the offsets alone set the widths
    width = next((w for w in (4, 2) if d % w == 0 and tab_off % w == 0
                  and in_off % w == 0), 1)
    assert sa.load_width(tables, merged) == width
    a0, s0 = sa.LAUNCHES_ADAM, sa.LAUNCHES_SGD
    touched = sparse_held(tables, uniq, merged,
                          torch.tensor([3e-3], device=cuda), vocab)
    assert (sa.LAUNCHES_ADAM - a0, sa.LAUNCHES_SGD - s0) == (1, 1)
    assert touched.any()


@pytest.mark.parametrize("d", [10, 1, 4, 33])
def test_sparse_row_kernels_with_no_rows_or_only_padding(cuda, d):
    """N = 0 launches nothing and changes nothing; ids that are all padding
    (== V) launch the kernels and touch no row, V-1 included."""
    vocab = 500
    tables, _, _ = sparse_case(cuda, vocab, d, 50, 3)
    lr_t = torch.tensor([3e-3], device=cuda)
    empty_ids = torch.empty(0, dtype=torch.int64, device=cuda)
    empty_rows = torch.empty(0, d, device=cuda)
    olds = [t.clone() for t in tables]
    a0, s0 = sa.LAUNCHES_ADAM, sa.LAUNCHES_SGD
    sa.sparse_adam_rows(*tables, empty_ids, empty_rows, lr_t)
    sa.sparse_sgd_rows(tables[0], empty_ids, empty_rows, lr_t)
    assert (sa.LAUNCHES_ADAM, sa.LAUNCHES_SGD) == (a0, s0)
    pad_ids = torch.full((37,), vocab, dtype=torch.int64, device=cuda)
    pad_rows = torch.randn(37, d, device=cuda)
    sa.sparse_adam_rows(*tables, pad_ids, pad_rows, lr_t)
    sa.sparse_sgd_rows(tables[0], pad_ids, pad_rows, lr_t)
    torch.cuda.synchronize()
    assert (sa.LAUNCHES_ADAM, sa.LAUNCHES_SGD) == (a0 + 1, s0 + 1)
    for t, old in zip(tables, olds):
        assert torch.equal(t.view(torch.int32), old.view(torch.int32))


def test_sparse_sgd_past_2_to_the_31_elements(cuda):
    """K4b on one [1.4e8, 16] table (8.96 GB; element offsets id * 16 pass
    2^31): the touched rows against the plain version run on the rows
    gathered before the update, bit-equal; the rows beside each touched row
    (when untouched) unchanged."""
    vocab, d, n = 140_000_000, 16, 4096
    if torch.cuda.get_device_properties(cuda).total_memory < 16e9:
        pytest.skip("needs a card with 16 GB")
    g = torch.Generator(device=cuda).manual_seed(0)
    p = torch.empty(vocab, d, device=cuda).normal_(generator=g)
    raw = torch.randint(0, vocab, (n,), generator=g, device=cuda)
    raw[:8] = torch.arange(vocab - 9, vocab - 1, device=cuda)  # the far end
    from paddle_tpu_torch.core.sparse import merge_rows

    uniq, merged = merge_rows(raw, torch.randn(n, d, generator=g,
                                               device=cuda), vocab)
    valid = uniq[uniq < vocab]
    assert int(valid.max()) * d > 2 ** 31
    near = torch.cat([valid - 1, valid + 1]).clamp(0, vocab - 1)
    near = near[~torch.isin(near, valid)]
    before, near_before = p[valid].clone(), p[near].clone()
    lr = torch.tensor([0.25], device=cuda)
    want = sa.sparse_sgd_rows_reference(
        before.clone(), torch.arange(valid.shape[0], device=cuda),
        merged[:valid.shape[0]], lr)
    sa.sparse_sgd_rows(p, uniq, merged, lr)
    torch.cuda.synchronize()
    assert torch.equal(p[valid].view(torch.int32), want.view(torch.int32))
    assert torch.equal(p[near].view(torch.int32),
                       near_before.view(torch.int32))
    del p


def test_sparse_row_kernel_wrapper_rules(cuda):
    """The wrappers take float32 tables and int64 ids and raise on others;
    they update in place and return the tables they were given."""
    (p, m, v), uniq, merged = sparse_case(cuda, 100, 4, 50, 1)
    out = sa.sparse_adam_rows(p, m, v, uniq, merged, 1e-3)
    assert out[0] is p and out[1] is m and out[2] is v
    assert sa.sparse_sgd_rows(p, uniq, merged, 1e-3) is p
    with pytest.raises(TypeError):
        sa.sparse_sgd_rows(p.double(), uniq, merged.double(), 1e-3)
    with pytest.raises(TypeError):
        sa.sparse_sgd_rows(p, uniq.int(), merged, 1e-3)
    with pytest.raises(ValueError):
        sa.sparse_sgd_rows(p.t(), uniq, merged, 1e-3)


def test_deepfm_trains_through_the_row_kernels(cuda):
    """A small DeepFM with Adam launches K4a twice a step (the [V, E] and
    [V, 1] tables) and K2a/K2b once, with SGD K4b twice; losses fall."""
    from paddle_tpu_torch.models import deepfm

    for opt, counter in (("adam", "LAUNCHES_ADAM"), ("sgd", "LAUNCHES_SGD")):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            ids = fluid.layers.data("ids", shape=[8], dtype="int64")
            dense = fluid.layers.data("dense", shape=[13])
            label = fluid.layers.data("label", shape=[1], dtype="int64")
            _, loss, _ = deepfm.deepfm(ids, dense, label,
                                       sparse_feature_dim=1000,
                                       embedding_size=4, num_fields=8,
                                       layer_sizes=(16, 16))
            (fluid.optimizer.Adam(1e-2) if opt == "adam"
             else fluid.optimizer.SGD(1e-1)).minimize(loss)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(0)
        feed = {"ids": rng.randint(0, 1000, (32, 8)).astype("int64"),
                "dense": rng.rand(32, 13).astype("float32"),
                "label": rng.randint(0, 2, (32, 1)).astype("int64")}
        k0, f0 = getattr(sa, counter), sx.LAUNCHES_FWD
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0]) for _ in range(5)]
        assert getattr(sa, counter) - k0 == 10
        assert sx.LAUNCHES_FWD - f0 == 5
        assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_resnet_trains_on_the_card_as_on_the_cpu(cuda):
    """ResNet-18 (``resnet_cifar10``) at 32 x 32, batch 8, Momentum(1e-3,
    0.9), cuDNN deterministic: three steps on the card launch K2a and K2b
    once each a step, and their losses match three on the CPU from the
    same state to 1e-4 relative."""
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", shape=[3, 32, 32])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        _, loss, _ = resnet.resnet_cifar10(img, label, depth=18)
        fluid.optimizer.Momentum(1e-3, 0.9).minimize(loss)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    arrays = {n: init.as_numpy(n) for n in init.vars}
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(8, 3, 32, 32).astype("float32"),
            "label": rng.randint(0, 10, (8, 1)).astype("int64")}
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    try:
        losses = []
        for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
            scope = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                              place)
            exe = fluid.Executor(place)
            f0, b0 = sx.LAUNCHES_FWD, sx.LAUNCHES_BWD
            losses.append([float(exe.run(main, feed=feed, fetch_list=[loss],
                                         scope=scope)[0]) for _ in range(3)])
            launched = (sx.LAUNCHES_FWD - f0, sx.LAUNCHES_BWD - b0)
            assert launched == ((3, 3) if place != fluid.CPUPlace()
                                else (0, 0))
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.allow_tf32 = prev
    card, cpu = losses
    np.testing.assert_allclose(card, cpu, rtol=1e-4)
    assert card[-1] < card[0]


def test_gather_sums_repeated_rows_on_the_card(cuda):
    """``gather`` at an index that repeats rows (BERT's masked positions
    may): the card's rows equal the CPU's bit for bit, and its gradient,
    summed by atomic adds, matches the CPU's to 1e-6."""
    from paddle_tpu_torch.core.registry import OpContext, get_op_impl
    from paddle_tpu_torch.core.framework import Operator, Program

    rng = np.random.RandomState(0)
    x = rng.randn(640, 768).astype(np.float32)
    idx = rng.randint(0, 64, (2048, 1)).astype(np.int64)
    g = rng.randn(2048, 768).astype(np.float32)
    op = Operator(Program().global_block, "gather",
                  inputs={"X": ["x"], "Index": ["i"]}, outputs={"Out": ["o"]})
    outs = []
    for dev in (cuda, torch.device("cpu")):
        xt = torch.as_tensor(x, device=dev).requires_grad_(True)
        env = {"x": xt, "i": torch.as_tensor(idx, device=dev)}
        get_op_impl("gather")(OpContext(op, env, None))
        dx, = torch.autograd.grad(env["o"], [xt],
                                  torch.as_tensor(g, device=dev))
        outs.append((env["o"].detach().cpu(), dx.cpu()))
    (o_card, dx_card), (o_cpu, dx_cpu) = outs
    assert torch.equal(o_card, o_cpu)
    torch.testing.assert_close(dx_card, dx_cpu, rtol=1e-6, atol=1e-5)


def test_bert_predictor_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A tiny BERT inference model saved by the port loads into a
    ``Predictor`` on the card (the default device) and into one on the
    CPU; at batch 5 (bucketed to 8) their outputs agree to 1e-5, and the
    loaded parameters live on the card."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models import bert

    seq = 16
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds = [fluid.layers.data(n, shape=[seq], dtype="int64")
                 for n in ("ids", "pos", "sent")]
        mask = fluid.layers.data("mask", shape=[seq], dtype="float32")
        _, pooled = bert.bert_tiny(*feeds, mask, dropout_rate=0.0,
                                   is_test=True)
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path),
                                      ["ids", "pos", "sent", "mask"],
                                      [pooled], exe, main_program=main)
    rng = np.random.RandomState(0)
    args = [rng.randint(0, 64, (5, seq)).astype("int64"),
            np.tile(np.arange(seq), (5, 1)).astype("int64"),
            rng.randint(0, 2, (5, seq)).astype("int64"),
            (rng.rand(5, seq) > 0.2).astype("float32")]
    config = inference.AnalysisConfig(str(tmp_path))
    config.switch_batch_bucketing(True)
    card = inference.create_predictor(config)
    assert card._exe.place.type == "cuda"
    assert all(v.device.type == "cuda" for v in card._scope.vars.values())
    config = inference.AnalysisConfig(str(tmp_path))
    config.switch_batch_bucketing(True)
    config.disable_gpu()
    cpu = inference.create_predictor(config)
    got, = card.run(args)
    want, = cpu.run(args)
    assert got.shape == (5, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
