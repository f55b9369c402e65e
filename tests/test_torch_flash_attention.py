"""The port's flash attention against the JAX package.

On the CPU the port's wrappers take their plain versions
(``flash_fwd_reference``, ``flash_bwd_dkv_reference``,
``flash_bwd_dq_reference``). They are held against the JAX package's Pallas
kernels, whose real bodies run in the Pallas interpreter
(``fa.INTERPRET = True``, as ``test_flash_dropout.py`` runs them), on inputs
made with numpy from a seed.

Tolerances, all float32: outputs and gradients to 2e-5 absolute and 1e-5
relative. Both sides do the same arithmetic in another order (the Pallas
kernel tile by tile with a running maximum, the plain version over whole
rows), which moves a sum of a few hundred O(1) terms by a few 1e-6. The
dropout keep mask is integer arithmetic and must agree bit for bit.

The Pallas kernels add the bias before they scale, the port scales first
(as the composed attention of both packages does); the tests hand the JAX
kernel ``bias / sm_scale`` with ``sm_scale`` a power of two, which is exact,
and compare its bias gradient divided by the same factor.

The CUDA kernels themselves are held against the plain versions on the
card by ``test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention_ops as jao
from paddle_tpu.ops.pallas_kernels import flash_attention as jfa
from paddle_tpu_torch.flags import set_flag
from paddle_tpu_torch.ops import attention_ops as tao
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

ATOL, RTOL = 2e-5, 1e-5
SM = 0.125  # a power of two: bias / SM is exact


@pytest.fixture(autouse=True)
def _interpret_and_flags():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False
    set_flag("flash_attention_min_seq", 2048)


def make(b, h, sq, sk, d, bias, seg, seed=0):
    rng = np.random.RandomState(seed)
    x = {n: rng.randn(b, h, s, d).astype(np.float32)
         for n, s in (("q", sq), ("k", sk), ("v", sk), ("do", sq))}
    x["ab"] = rng.randn(b, h, sq, sk).astype(np.float32) if bias else None
    # sorted ids shared by q and kv: every row sees at least itself
    ids = np.sort(rng.randint(0, 3, (b, max(sq, sk))), axis=-1)
    x["seg"] = (ids[:, :sq].astype(np.int32),
                ids[:, :sk].astype(np.int32)) if seg else None
    return x


def t(a):
    return None if a is None else torch.as_tensor(a)


def port_seg(x):
    return None if x["seg"] is None else tfa.SegmentIds(*map(t, x["seg"]))


def jax_seg(x):
    return None if x["seg"] is None else jfa.SegmentIds(
        *map(jnp.asarray, x["seg"]))


def jax_bias(x):
    return None if x["ab"] is None else jnp.asarray(x["ab"] / SM)


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, **kw)


CASES = [(causal, bias, seg) for causal in (False, True)
         for bias in (False, True) for seg in (False, True)]


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal,bias,seg", CASES)
def test_plain_forward_matches_pallas_interpreter(causal, bias, seg, d):
    x = make(2, 2, 256, 256, d, bias, seg, seed=d)
    o, l, m = jfa._flash_attention_impl(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        jax_bias(x), jax_seg(x), True, causal, SM, 1, 128, 128, 128, False)
    got_o, got_lse = tfa.flash_fwd(t(x["q"]), t(x["k"]), t(x["v"]),
                                   t(x["ab"]), port_seg(x), causal, SM)
    assert got_o.dtype == torch.float32 and got_lse.shape == (2, 2, 256)
    close(got_o, o)
    close(got_lse, np.asarray(m) + np.log(np.asarray(l)))


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal,bias,seg", CASES)
def test_plain_backward_matches_pallas_vjp(causal, bias, seg, d):
    x = make(1, 2, 256, 256, d, bias, seg, seed=7 + d)
    args = [jnp.asarray(x[n]) for n in ("q", "k", "v")]
    if bias:
        args.append(jax_bias(x))

    def f(q, k, v, ab=None):
        return jfa.flash_attention(q, k, v, ab, jax_seg(x), causal=causal,
                                   sm_scale=SM)

    _, vjp = jax.vjp(f, *args)
    want = vjp(jnp.asarray(x["do"]))
    q, k, v = (t(x[n]).requires_grad_(True) for n in ("q", "k", "v"))
    ab = t(x["ab"])
    leaves = [q, k, v] + ([ab.requires_grad_(True)] if bias else [])
    o = tfa.flash_attention(q, k, v, ab, port_seg(x), causal=causal,
                            sm_scale=SM)
    got = torch.autograd.grad(o, leaves, t(x["do"]))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        close(g, w, err_msg=name)
    if bias:
        # d/d(bias / SM) = SM · d/d bias
        close(got[3], np.asarray(want[3]) / SM, err_msg="dab")


def test_ragged_lengths_match_the_reference_attention():
    """Sq != Sk, neither a multiple of a tile: held against the JAX
    package's ``mha_reference_no_custom_vjp`` and its autodiff."""
    x = make(2, 2, 70, 153, 32, True, True, seed=3)
    args = [jnp.asarray(x[n]) for n in ("q", "k", "v")] + [jax_bias(x)]

    def f(q, k, v, ab):
        return jfa.mha_reference_no_custom_vjp(q, k, v, ab, jax_seg(x),
                                               causal=False, sm_scale=SM)

    want_o, vjp = jax.vjp(f, *args)
    want = vjp(jnp.asarray(x["do"]))
    leaves = [t(x[n]).requires_grad_(True) for n in ("q", "k", "v", "ab")]
    o = tfa.flash_attention(*leaves, port_seg(x), causal=False, sm_scale=SM)
    got = torch.autograd.grad(o, leaves, t(x["do"]))
    close(o.detach(), want_o)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        close(g, w, err_msg=name)
    close(got[3], np.asarray(want[3]) / SM, err_msg="dab")


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.999999999, 1.0])
@pytest.mark.parametrize("seed,b,h,q0,k0", [
    (0, 0, 0, 0, 0), (12345, 3, 7, 128, 256), (-7, 1, 15, 1920, 64),
    (2 ** 31 - 1, 65535, 2, 5, 100001), (-2 ** 31, 7, 0, 4095, 4095)])
def test_dropout_keep_mask_is_bit_equal(rate, seed, b, h, q0, k0):
    """rate 1.0 and the one just below it hit the threshold's clamp to
    2^32 - 1."""
    want = jfa._dropout_keep_tile(rate, jnp.int32(seed), b, h, q0, k0,
                                  (40, 136))
    got = tfa.dropout_keep_mask(rate, seed, b, h, q0, k0, (40, 136))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if rate in (0.1, 0.5):
        assert abs(float(got.float().mean()) - (1 - rate)) < 0.03


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_forward_and_grads_match_flash_dropout(causal):
    """Rate 0.2, the same seed on both sides: the masks are the same bits,
    so outputs and gradients agree as closely as without dropout."""
    x = make(2, 2, 256, 256, 64, False, False, seed=11)
    seed, rate = 4242, 0.2
    args = [jnp.asarray(x[n]) for n in ("q", "k", "v")]
    want_o, vjp = jax.vjp(
        lambda q, k, v: jao._flash_dropout(
            q, k, v, jnp.asarray([seed], jnp.int32), causal, SM, rate), *args)
    want = vjp(jnp.asarray(x["do"]))
    leaves = [t(x[n]).requires_grad_(True) for n in ("q", "k", "v")]
    o = tfa.flash_attention(*leaves, causal=causal, sm_scale=SM,
                            dropout_rate=rate, dropout_seed=seed)
    got = torch.autograd.grad(o, leaves, t(x["do"]))
    close(o.detach(), want_o)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        close(g, w, err_msg=name)
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.flash_attention(*leaves, dropout_rate=rate)


def test_autograd_function_passes_gradcheck_in_float64():
    rng = np.random.RandomState(0)
    q, k, v = (torch.as_tensor(rng.randn(1, 2, 6, 32)).requires_grad_(True)
               for _ in range(3))
    ab = torch.as_tensor(rng.randn(1, 2, 6, 6)).requires_grad_(True)
    ids = torch.as_tensor([[0, 0, 0, 1, 1, 1]])
    assert torch.autograd.gradcheck(
        lambda q, k, v, ab: tfa.flash_attention(
            q, k, v, ab, tfa.SegmentIds(ids, ids), causal=True, sm_scale=0.3),
        (q, k, v, ab))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention(
            q, k, v, causal=False, sm_scale=0.3, dropout_rate=0.3,
            dropout_seed=5), (q, k, v))


def test_a_row_that_sees_nothing_gives_zero_and_no_gradient():
    """The port's choice for a fully masked row (the Pallas kernels and the
    composed path average v there): o = 0, lse = +inf, zero gradients."""
    x = make(1, 2, 8, 8, 32, False, False, seed=5)
    ids_q = torch.as_tensor([[0, 0, 1, 1, 1, 1, 1, 1]])
    ids_kv = torch.ones(1, 8, dtype=torch.int64)
    leaves = [t(x[n]).requires_grad_(True) for n in ("q", "k", "v")]
    seg = tfa.SegmentIds(ids_q, ids_kv)
    o, lse = tfa.flash_fwd(*leaves, None, seg)
    assert not o[:, :, :2].any() and bool(torch.isinf(lse[:, :, :2]).all())
    out = tfa.flash_attention(*leaves, None, seg)
    dq, dk, dv = torch.autograd.grad(out, leaves, t(x["do"]))
    assert not dq[:, :, :2].any()
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    # the rows that do see something are the composed attention's
    want = tao.sdpa(*leaves, None, ids_q, ids_kv)
    close(out[:, :, 2:].detach(), want[:, :, 2:].detach())


@pytest.mark.parametrize("causal,bias,seg", CASES)
def test_sdpa_flash_route_equals_composed(causal, bias, seg):
    """With the flag at 128 ``sdpa`` takes the flash route; at 2048 the
    same call is composed. A bias with sm_scale != 1 pins "scale first"."""
    x = make(2, 2, 128, 128, 32, bias, seg, seed=2)
    if bias:  # broadcast over heads, as the Transformer's padding bias is
        x["ab"] = x["ab"][:, :1]
    seg_q, seg_kv = (None, None) if not seg else map(t, x["seg"])

    def run(min_seq):
        set_flag("flash_attention_min_seq", min_seq)
        leaves = [t(x[n]).requires_grad_(True) for n in ("q", "k", "v")]
        ab = t(x["ab"])
        if bias:
            leaves.append(ab.requires_grad_(True))
        before = calls["n"]
        o = tao.sdpa(leaves[0], leaves[1], leaves[2], ab, seg_q, seg_kv,
                     causal, 0.3)
        grads = torch.autograd.grad(o, leaves, t(x["do"]))
        return o.detach(), grads, calls["n"] - before

    calls = {"n": 0}
    orig = tfa.flash_fwd_reference

    def spy(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    tfa.flash_fwd_reference = spy
    try:
        o_f, g_f, n_f = run(128)
        o_c, g_c, n_c = run(2048)
    finally:
        tfa.flash_fwd_reference = orig
    assert (n_f, n_c) == (1, 0)
    close(o_f, o_c)
    for a, b_ in zip(g_f, g_c):
        close(a, b_)


def test_sdpa_dropout_routes():
    """Dropout with neither bias nor segments goes through the kernels'
    own mask; with a bias it is composed. Below the flag nothing reaches
    the flash wrapper."""
    x = make(1, 2, 128, 128, 32, True, False, seed=9)
    q, k, v = (t(x[n]) for n in ("q", "k", "v"))
    calls = {"n": 0}
    orig = tfa.flash_fwd_reference

    def spy(*a, **kw):
        calls["n"] += 1
        calls["rate"] = a[7]
        return orig(*a, **kw)

    def gen():
        return torch.Generator().manual_seed(3)

    tfa.flash_fwd_reference = spy
    try:
        set_flag("flash_attention_min_seq", 128)
        a = tao.sdpa(q, k, v, causal=True, sm_scale=0.2, dropout_rate=0.25,
                     dropout_rng=gen())
        assert calls == {"n": 1, "rate": 0.25}
        b_ = tao.sdpa(q, k, v, causal=True, sm_scale=0.2, dropout_rate=0.25,
                      dropout_rng=gen())
        np.testing.assert_array_equal(a.numpy(), b_.numpy())
        tao.sdpa(q, k, v, t(x["ab"]), causal=True, sm_scale=0.2,
                 dropout_rate=0.25, dropout_rng=gen())
        assert calls["n"] == 2  # the second call above; the biased one: none
        set_flag("flash_attention_min_seq", 2048)
        tao.sdpa(q, k, v, causal=True, sm_scale=0.2)
        tao.sdpa(q[:, :, :100], k, v, causal=False, sm_scale=0.2)
        assert calls["n"] == 2
        # causal with Sq != Sk stays composed at any flag
        set_flag("flash_attention_min_seq", 64)
        tao.sdpa(q[:, :, :100], k, v, causal=True, sm_scale=0.2)
        assert calls["n"] == 2
    finally:
        tfa.flash_fwd_reference = orig


def test_wrapper_device_rule_checks_and_launch_counts():
    x = make(1, 2, 16, 16, 32, False, False)
    q, k, v = (t(x[n]) for n in ("q", "k", "v"))
    n0 = (tfa.LAUNCHES_FWD, tfa.LAUNCHES_DKV, tfa.LAUNCHES_DQ)
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    torch.autograd.grad(tfa.flash_attention(*leaves).sum(), leaves)
    assert (tfa.LAUNCHES_FWD, tfa.LAUNCHES_DKV, tfa.LAUNCHES_DQ) == n0
    # a bias that needs no gradient gets none computed for it
    ab = torch.zeros(1, 2, 16, 16)
    o, lse = tfa.flash_fwd(q, k, v, ab)
    do = torch.ones_like(o)
    di = (o * do).sum(-1)
    dq, dab = tfa.flash_bwd_dq(q, k, v, ab, None, lse, do, di)
    dq2, none = tfa.flash_bwd_dq(q, k, v, ab, None, lse, do, di,
                                 need_dab=False)
    assert dab.shape == ab.shape and none is None and torch.equal(dq, dq2)
    meta = torch.empty(1, 2, 16, 32, device="meta")
    assert tfa.flash_attention(meta, meta, meta).shape == (1, 2, 16, 32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_fwd(meta, meta, meta)
    with pytest.raises(ValueError, match=r"\[B,H,S,D\]"):
        tfa.flash_fwd(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="k and v must be"):
        tfa.flash_fwd(q, k[:, :1], v)
    with pytest.raises(TypeError, match="dtypes differ"):
        tfa.flash_fwd(q, k.double(), v)
    with pytest.raises(ValueError, match="ab must be"):
        tfa.flash_fwd(q, k, v, torch.zeros(1, 1, 16, 16))
    with pytest.raises(ValueError, match="segment ids must be"):
        tfa.flash_fwd(q, k, v, None, tfa.SegmentIds(
            torch.zeros(1, 8, dtype=torch.int64),
            torch.zeros(1, 16, dtype=torch.int64)))
    with pytest.raises(ValueError, match="dropout_rate"):
        tfa.flash_fwd(q, k, v, dropout_rate=1.0)


def _view(kind, dt, b=2, h=4, s=16, d=32):
    """A [B,H,S,D] view of dtype ``dt`` of the kind the wrappers may be
    handed."""
    if kind == "contiguous":
        return torch.randn(b, h, s, d).to(dt)
    if kind == "bshd_transpose":  # the attention layer's head view
        return torch.randn(b, s, h, d).to(dt).transpose(1, 2)
    if kind == "fused_qkv_slice":  # k of one [B,S,3·H·D] projection
        qkv = torch.randn(b, s, 3 * h * d).to(dt)
        return qkv[:, :, h * d:2 * h * d].view(b, s, h, d).transpose(1, 2)
    flat = torch.randn(b * h * s * d + 1).to(dt)  # one element off
    return flat[1:].view(b, h, s, d)


_VIEWS = [("contiguous", True), ("bshd_transpose", True),
          ("fused_qkv_slice", True), ("offset_by_one_element", False)]


@pytest.mark.parametrize("kind,aligned,dt", [
    pytest.param(kind, aligned, dt,
                 id=("" if dt == torch.bfloat16 else "float32-")
                 + "%s-%s" % (kind, aligned))
    for dt in (torch.bfloat16, torch.float32) for kind, aligned in _VIEWS])
def test_bf16_kernels_copy_only_views_off_16_bytes(kind, aligned, dt):
    """The kernels load with 16-byte copies (K1a, K1b and K1c, in bfloat16
    8 elements to 16 bytes, in float32 4): a view whose base or strides
    miss 16 bytes is handed over as an aligned copy with the same values,
    every other view as it is."""
    t = _view(kind, dt)
    assert tfa._cp_async_ok(t) is aligned
    staged = tfa._staged(t)
    assert (staged is t) is aligned
    assert tfa._cp_async_ok(staged) and torch.equal(staged, t)


# -- a float32 bias under bfloat16 q, k, v ------------------------------------


def bf16_scaled_err(got, want):
    """Largest |got − want| / (2e-2·|want| + 1e-6·row max |want|): the bf16
    check scale of the port's chip checks; at most 1 passes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    row = np.abs(want).max(axis=-1, keepdims=True)
    return float((np.abs(got - want)
                  / (2e-2 * np.abs(want) + 1e-6 * row + 1e-30)).max())


def f32_bias_inputs(seed=21):
    """bfloat16 q, k, v, do [1, 2, 128, 64] and a float32 bias of std 8,
    whose rounding to bfloat16 would move a score by up to 0.03."""
    x = make(1, 2, 128, 128, 64, True, False, seed=seed)
    for n in ("q", "k", "v", "do"):
        x[n] = np.array(jnp.asarray(x[n], jnp.bfloat16).astype(jnp.float32))
    x["ab"] = x["ab"] * 8.0
    return x


def bf16(a):
    return torch.as_tensor(a).to(torch.bfloat16)


def test_composed_sdpa_promotes_under_a_float32_bias():
    """bfloat16 q, k, v with a float32 bias: the JAX package's composed
    ``sdpa`` promotes the scores, the softmax and the output to float32;
    the port's does the same, where it used to raise."""
    x = f32_bias_inputs()
    want = jao.sdpa(*(jnp.asarray(x[n], jnp.bfloat16) for n in "qkv"),
                    jnp.asarray(x["ab"]), causal=True, sm_scale=SM)
    got = tao.sdpa(*(bf16(x[n]) for n in "qkv"), t(x["ab"]), causal=True,
                   sm_scale=SM)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert bf16_scaled_err(got, want) <= 1
    # a bias in q's own dtype keeps the bfloat16 path
    same = tao.sdpa(*(bf16(x[n]) for n in "qkv"), bf16(x["ab"]), causal=True,
                    sm_scale=SM)
    assert same.dtype == torch.bfloat16


def head_err(got, want):
    """Largest |got − want| over the largest |want| of the head."""
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    head = np.abs(want).max(axis=(-2, -1), keepdims=True)
    return float((np.abs(got - want) / head).max())


@pytest.mark.parametrize("causal", [False, True])
def test_plain_versions_read_a_float32_bias_as_the_pallas_kernels(causal):
    """The plain K1a/K1b/K1c with bfloat16 q, k, v and a float32 bias
    against the Pallas kernels in the interpreter, which read the bias in
    its own dtype and add it in float32; ``dab`` comes back float32.

    Tolerance: 1.5e-2 of the head's largest value. Both sides round p and
    ds·scale to bfloat16 before their products (against another maximum)
    and round o, dq, dk, dv to bfloat16, and each lies up to ~1 % of that
    value from a float64 truth. A bias of std 8 makes the softmax peaked, so
    many dq rows cancel to about 0 and an element-wise relative bound does
    not apply. The bias rounded to bfloat16 first puts o 2.3–2.6 % off,
    which the bound rejects."""
    x = f32_bias_inputs(seed=22 + causal)
    jq, jk, jv, jdo = (jnp.asarray(x[n], jnp.bfloat16)
                       for n in ("q", "k", "v", "do"))

    def f(q, k, v, ab):
        return jfa.flash_attention(q, k, v, ab, None, causal=causal,
                                   sm_scale=SM)

    want_o, vjp = jax.vjp(f, jq, jk, jv, jax_bias(x))
    want = vjp(jdo)
    leaves = [bf16(x[n]).requires_grad_(True) for n in ("q", "k", "v")]
    ab = t(x["ab"]).requires_grad_(True)
    o = tfa.flash_attention(*leaves, ab, causal=causal, sm_scale=SM)
    got = torch.autograd.grad(o, leaves + [ab], bf16(x["do"]))
    assert o.dtype == torch.bfloat16 and got[3].dtype == torch.float32
    assert head_err(o.detach(), want_o) <= 1.5e-2, "o"
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert head_err(g, w) <= 1.5e-2, name
    # d/d(bias / SM) = SM · d/d bias
    assert head_err(got[3], np.asarray(want[3], np.float32) / SM) <= 1.5e-2
    rounded, _ = tfa.flash_fwd(*(a.detach() for a in leaves), bf16(x["ab"]),
                               causal=causal, sm_scale=SM)
    assert head_err(rounded, want_o) > 1.5e-2


def test_flash_route_reads_a_float32_bias_in_float32():
    """The flash route of ``sdpa`` with bfloat16 q, k, v and a float32
    bias of std 8 returns q's dtype, within 2e-2 of a float64 truth that
    uses the float32 bias. Rounding the bias to bfloat16 first put it 0.094
    off."""
    x = f32_bias_inputs(seed=24)
    set_flag("flash_attention_min_seq", 128)
    calls = {"n": 0}
    orig = tfa.flash_fwd_reference

    def spy(*a, **kw):
        calls["n"] += 1
        assert a[3].dtype == torch.float32  # the bias as it was handed over
        return orig(*a, **kw)

    tfa.flash_fwd_reference = spy
    try:
        got = tao.sdpa(*(bf16(x[n]) for n in "qkv"), t(x["ab"]), causal=True,
                       sm_scale=SM)
    finally:
        tfa.flash_fwd_reference = orig
    assert calls["n"] == 1 and got.dtype == torch.bfloat16
    q, k, v, ab = (torch.as_tensor(x[n], dtype=torch.float64)
                   for n in ("q", "k", "v", "ab"))
    s = q @ k.transpose(-1, -2) * SM + ab
    s = s.masked_fill(~torch.ones(128, 128, dtype=torch.bool).tril(),
                      float("-inf"))
    truth = torch.softmax(s, dim=-1) @ v
    assert float((got.double() - truth).abs().max()) <= 2e-2
    with pytest.raises(TypeError, match="float32 under bfloat16"):
        tfa.flash_fwd(*(t(x[n]) for n in "qkv"), bf16(x["ab"]))


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_op_matches_jax(approximate):
    rng = np.random.RandomState(0)
    xs = (rng.randn(4, 33) * 3).astype(np.float32)
    want = jax.nn.gelu(jnp.asarray(xs), approximate=approximate)
    import paddle_tpu_torch as tfluid

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        xv = tfluid.layers.data("x", shape=[33])
        out = tfluid.layers.fc(xv, 33, bias_attr=False,
                               act={"type": "gelu",
                                    "approximate": approximate})
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    w = main.all_parameters()[0].name
    scope.set_var(w, torch.eye(33))
    got, = exe.run(main, feed={"x": xs}, fetch_list=[out], scope=scope)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-6)
