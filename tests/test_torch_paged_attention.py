"""The port's ragged paged-attention wrapper against the JAX package.

On the CPU the wrapper takes its plain version (the page gather + the
port's ``decode_attention``); it is held against the JAX Pallas kernel in
interpret mode and against the JAX gather path, at the JAX selftest's
shapes, to 1e-6 (float32, same math, different summation order). Garbage
beyond ``ctx_len`` must move no output bit. The kernel itself is held
against the plain version on the card by ``test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention_ops as jattn
from paddle_tpu.ops.pallas_kernels import paged_attention as jpa
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu_torch.flags import set_flag
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.serving import kv_cache as tkv

SLOTS, H, D, PS, PPS, NUM_PAGES = 5, 2, 16, 8, 8, 24  # the JAX selftest's
SM = 1.0 / D ** 0.5


@pytest.fixture(autouse=True)
def _restore_flag():
    yield
    set_flag("paged_attention_kernel", "auto")


def make_pool(seed, dtype=np.float32):
    """One layer's pool with slots owning disjoint, scrambled page sets."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(NUM_PAGES)
    pt = np.zeros((SLOTS, PPS), np.int32)
    for s in range(SLOTS):
        pt[s] = np.resize(perm[s::SLOTS], PPS)
    k = rng.randn(NUM_PAGES * PS, H, D).astype(dtype)
    v = rng.randn(NUM_PAGES * PS, H, D).astype(dtype)
    q = rng.randn(SLOTS, H, D).astype(dtype)
    return q, k, v, pt


def port(q, k, v, pt, ctx):
    return tpa.paged_decode_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(pt), torch.as_tensor(ctx), page_size=PS,
        sm_scale=SM).numpy()


def live_rows(pt, ctx):
    live = np.zeros(NUM_PAGES * PS, bool)
    for s in range(SLOTS):
        flat = pt[s].repeat(PS) * PS + np.tile(np.arange(PS), PPS)
        live[flat[:int(ctx[s])]] = True
    return live


CTX_PATTERNS = {
    "selftest": [1, 7, 8, 33, 64],    # 1 token, mid-page, page-exact, full
    "full": [64, 64, 64, 64, 64],
    "single": [1, 1, 1, 1, 1],
    "straddle": [9, 16, 17, 40, 63],
}


@pytest.mark.parametrize("pattern", sorted(CTX_PATTERNS))
def test_plain_version_matches_jax_kernel_and_gather(pattern):
    q, k, v, pt = make_pool(0)
    ctx = np.asarray(CTX_PATTERNS[pattern], np.int32)
    got = port(q, k, v, pt, ctx)
    args = tuple(map(jnp.asarray, (q, k, v, pt, ctx)))
    kern = np.asarray(jpa.paged_decode_attention(
        *args, page_size=PS, sm_scale=SM, block_pages=2, interpret=True))
    gath = np.asarray(jpa.gather_reference(*args, PS, sm_scale=SM))
    np.testing.assert_allclose(got, kern, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, gath, rtol=1e-6, atol=1e-6)


def test_garbage_beyond_ctx_len_moves_no_output_bit():
    q, k, v, pt = make_pool(1)
    ctx = np.asarray(CTX_PATTERNS["selftest"], np.int32)
    clean = port(q, k, v, pt, ctx)
    dead = ~live_rows(pt, ctx)
    rng = np.random.RandomState(2)
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[dead] = 1e4 * rng.randn(int(dead.sum()), H, D)
    v_bad[dead] = -1e4
    np.testing.assert_array_equal(port(q, k_bad, v_bad, pt, ctx), clean)


def test_cpu_dispatch_launches_no_kernel():
    q, k, v, pt = make_pool(3)
    before = tpa.LAUNCHES
    port(q, k, v, pt, np.asarray(CTX_PATTERNS["full"], np.int32))
    assert tpa.LAUNCHES == before


def _bad_inputs():
    q, k, v, pt = (torch.as_tensor(a) for a in make_pool(4))
    ctx = torch.full((SLOTS,), 9, dtype=torch.int32)
    wide = torch.zeros(SLOTS, H, tpa.MAX_D + 32)
    wide_pool = torch.zeros(NUM_PAGES * PS, H, tpa.MAX_D + 32)
    return {
        "q_float64": ((q.double(), k, v, pt, ctx), TypeError),
        "pools_mixed_dtype": ((q, k.bfloat16(), v, pt, ctx), TypeError),
        "pt_int64": ((q, k, v, pt.long(), ctx), TypeError),
        "ctx_float": ((q, k, v, pt, ctx.float()), TypeError),
        "q_2d": ((q[0], k, v, pt, ctx), ValueError),
        "pool_heads": ((q, k[:, :1], v[:, :1], pt, ctx), ValueError),
        "pool_rows_not_pages": ((q, k[:-1], v[:-1], pt, ctx), ValueError),
        "pt_slots": ((q, k, v, pt[:-1], ctx), ValueError),
        "ctx_shape": ((q, k, v, pt, ctx[:, None]), ValueError),
        "q_not_contiguous": ((q.transpose(0, 1).contiguous().transpose(0, 1),
                              k, v, pt, ctx), ValueError),
        "d_too_wide": ((wide, wide_pool, wide_pool, pt, ctx), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_rejects_bad_inputs(case):
    args, exc = _bad_inputs()[case]
    with pytest.raises(exc):
        tpa.paged_decode_attention(*args, page_size=PS, sm_scale=SM)


@pytest.mark.parametrize("kernel_flag", ["auto", "off"])
def test_decode_verify_matches_jax(kernel_flag):
    """Verify windows flattened into pseudo-slots (the kernel's second
    caller) and the gather + verify_attention path both match the JAX
    gather path."""
    n_layer, w = 1, 3
    q, k, v, pt = make_pool(5)
    rng = np.random.RandomState(6)
    qw = rng.randn(SLOTS, w, H, D).astype(np.float32)
    ctx = np.asarray([1, 7, 8, 33, 60], np.int32)
    jc = jkv.PagedKVCache(n_layer, H, D, SLOTS, PPS * PS, PS, NUM_PAGES)
    jstate = {"k": jnp.asarray(k)[None], "v": jnp.asarray(v)[None],
              "pt": jnp.asarray(pt)}
    want = np.asarray(jattn.verify_attention(
        jnp.asarray(qw), *jc.context(jstate, 0), jnp.asarray(ctx),
        sm_scale=SM))
    tc = tkv.PagedKVCache(n_layer, H, D, SLOTS, PPS * PS, PS, NUM_PAGES,
                          device="cpu")
    tstate = tc.init_state()
    tstate["k"][0, :NUM_PAGES * PS] = torch.as_tensor(k)
    tstate["v"][0, :NUM_PAGES * PS] = torch.as_tensor(v)
    tstate["pt"][:] = torch.as_tensor(pt)
    set_flag("paged_attention_kernel", kernel_flag)
    got = tc.decode_verify(tstate, 0, torch.as_tensor(qw),
                           torch.as_tensor(ctx), sm_scale=SM).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_interpret_flag_has_no_meaning_here():
    set_flag("paged_attention_kernel", "interpret")
    from paddle_tpu_torch.ops import attention_ops

    with pytest.raises(ValueError):
        attention_ops.paged_kernel_enabled()


# -- the kernel's split over the context, in plain PyTorch -------------------
#
# The CUDA kernel cuts each slot's live rows into chunks of CHUNK_ROWS rows,
# one block a chunk, and merges the chunks' (m, l, acc) in chunk order.
# chunked_reference is that arithmetic; it is held here against the JAX
# kernel (interpret mode) and the gather path on a pool whose slots hold
# four chunks each.

LONG_PPS = 4 * tpa.CHUNK_ROWS // PS  # pages a slot: four chunks of rows
LONG_PAGES = SLOTS * LONG_PPS

LONG_CTX = {
    "chunks_beyond_ctx": [1, 7, tpa.CHUNK_ROWS + 6, 2 * tpa.CHUNK_ROWS, 33],
    "ctx_1": [1, 1, 1, 1, 1],
    "ctx_max": [LONG_PPS * PS] * SLOTS,
    "slot_with_ctx_0": [0, 5, LONG_PPS * PS, tpa.CHUNK_ROWS,
                        tpa.CHUNK_ROWS + 1],
}


def make_long_pool(seed):
    rng = np.random.RandomState(seed)
    perm = rng.permutation(LONG_PAGES)
    pt = np.stack([perm[s::SLOTS] for s in range(SLOTS)]).astype(np.int32)
    k = rng.randn(LONG_PAGES * PS, H, D).astype(np.float32)
    v = rng.randn(LONG_PAGES * PS, H, D).astype(np.float32)
    q = rng.randn(SLOTS, H, D).astype(np.float32)
    return q, k, v, pt


def chunked(q, k, v, pt, ctx, chunk_rows=tpa.CHUNK_ROWS):
    return tpa.chunked_reference(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(pt), torch.as_tensor(ctx), PS, SM,
        chunk_rows).numpy()


@pytest.mark.parametrize("pattern", sorted(LONG_CTX))
def test_chunked_split_matches_jax_kernel_and_gather(pattern):
    """At the wrapper's chunk size, to 1e-6. A slot with no live row gives
    0, as the JAX kernel does; the gather paths (both packages') average v
    there, so they are compared on the live slots."""
    q, k, v, pt = make_long_pool(7)
    ctx = np.asarray(LONG_CTX[pattern], np.int32)
    got = chunked(q, k, v, pt, ctx)
    args = tuple(map(jnp.asarray, (q, k, v, pt, ctx)))
    kern = np.asarray(jpa.paged_decode_attention(
        *args, page_size=PS, sm_scale=SM, block_pages=4, interpret=True))
    gath = np.asarray(jpa.gather_reference(*args, PS, sm_scale=SM))
    live = ctx > 0
    np.testing.assert_allclose(got, kern, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[live], gath[live], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[live], port(q, k, v, pt, ctx)[live],
                               rtol=1e-6, atol=1e-6)
    assert not got[~live].any()


def test_chunked_split_ignores_a_poisoned_pool():
    q, k, v, pt = make_long_pool(8)
    ctx = np.asarray(LONG_CTX["chunks_beyond_ctx"], np.int32)
    clean = chunked(q, k, v, pt, ctx)
    flat = pt.repeat(PS, axis=1) * PS + np.tile(np.arange(PS), LONG_PPS)
    live = np.zeros(LONG_PAGES * PS, bool)
    for s in range(SLOTS):
        live[flat[s, :ctx[s]]] = True
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[~live] = 1e4
    v_bad[~live] = np.nan
    np.testing.assert_array_equal(chunked(q, k_bad, v_bad, pt, ctx), clean)


def test_chunk_plan_and_chunk_sizes():
    """The grid's chunk count covers the longest context the page table
    holds; the split's result does not depend on the chunk size beyond
    rounding."""
    assert tpa.chunk_plan(LONG_PPS, PS) == 4
    assert tpa.chunk_plan(64, 16) == 1024 // tpa.CHUNK_ROWS
    assert tpa.chunk_plan(3, 16, 40) == 2 and tpa.chunk_plan(1, 1, 64) == 1
    with pytest.raises(ValueError):
        tpa.chunk_plan(4, 16, 0)
    q, k, v, pt = make_long_pool(9)
    ctx = np.asarray(LONG_CTX["chunks_beyond_ctx"], np.int32)
    whole = chunked(q, k, v, pt, ctx, chunk_rows=LONG_PPS * PS)
    for rows in (1, 16, 48, tpa.CHUNK_ROWS):
        np.testing.assert_allclose(chunked(q, k, v, pt, ctx, rows), whole,
                                   rtol=1e-6, atol=1e-6)
