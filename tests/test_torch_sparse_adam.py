"""The port's rows-only sparse gradients against the JAX package.

* ``core.sparse.merge_rows`` against the JAX package's: the same sorted
  unique ids, merged rows within 1e-6, the padding tail == V with zero
  rows.
* The plain versions of K4a/K4b (``sparse_adam_rows_reference``,
  ``sparse_sgd_rows_reference``) against the Pallas kernels run by the
  Pallas interpreter (``interpret=True``) on the same merged rows, within
  1e-6 (relative and absolute): the plain version stores ``m + (m_new -
  m)`` where the kernel stores ``m_new``, one rounding apart.
* Padding ids clamp to row V-1 for the gather and leave it bit-equal, -0.0
  included; the wrappers update in place and take the plain versions for
  CPU tensors without counting a launch.
* The vector width the wrappers hand the kernels, from D and the pointers'
  alignment (fake pointers and real views).

The kernels themselves run only on the card (``test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import sparse as jsparse
from paddle_tpu.ops.pallas_kernels import sparse_adam as jsa
from paddle_tpu_torch.core import sparse as tsparse
from paddle_tpu_torch.ops.kernels import sparse_adam as tsa

TOL = 1e-6


def raw_ids(rng, vocab, n, pattern):
    if pattern == "one_id":
        return np.full(n, 7, np.int64)
    if pattern == "distinct":
        return rng.permutation(vocab)[:n].astype(np.int64)
    ids = rng.randint(0, vocab, n).astype(np.int64)
    ids[: n // 4] = ids[n // 4: 2 * (n // 4)]  # duplicates
    if pattern == "padded":
        ids[::5] = vocab  # masked ids, as the lookup hands them over
    return ids


def merged_case(seed, vocab, dim, n, pattern="dups"):
    rng = np.random.RandomState(seed)
    ids = raw_ids(rng, vocab, n, pattern)
    rows = rng.randn(n, dim).astype(np.float32)
    uniq, merged = tsparse.merge_rows(torch.tensor(ids), torch.tensor(rows),
                                      vocab)
    tables = (rng.randn(vocab, dim).astype(np.float32),
              (rng.randn(vocab, dim) * 0.1).astype(np.float32),
              (np.abs(rng.randn(vocab, dim)) * 0.01).astype(np.float32))
    return ids, rows, uniq, merged, tables


@pytest.mark.parametrize("vocab,dim,n,pattern", [
    (1000, 10, 96, "dups"), (50, 3, 64, "dups"), (100, 10, 32, "one_id"),
    (500, 1, 40, "distinct"), (200, 4, 60, "padded"), (30, 2, 1, "dups")])
def test_merge_rows_matches_jax(vocab, dim, n, pattern):
    ids, rows, uniq, merged, _ = merged_case(n + dim, vocab, dim, n, pattern)
    juniq, jmerged = jsparse.merge_rows(jnp.asarray(ids.astype(np.int32)),
                                        jnp.asarray(rows), vocab)
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(juniq))
    np.testing.assert_allclose(merged.numpy(), np.asarray(jmerged),
                               rtol=TOL, atol=TOL)
    k = len(np.unique(ids))
    assert (uniq[:k].numpy() == np.unique(ids)).all()
    assert (uniq[k:] == vocab).all() and not merged[k:].any()


# D = 10 (8 lanes of float2 a row) and 1 (one thread a row), DeepFM's
# widths, then one for each other vector width and lane count of the CUDA
# kernel: 7 and 33 scalar (33: two passes of 32 lanes), 2 float2, 4 and 16
# float4
CASES = [(500, 10, 64), (300, 1, 80), (64, 7, 40), (400, 2, 50),
         (300, 4, 60), (200, 16, 40), (150, 33, 30)]


@pytest.mark.parametrize("vocab,dim,n", CASES)
@pytest.mark.parametrize("pattern", ["dups", "padded"])
def test_adam_plain_version_matches_pallas_interpreter(vocab, dim, n,
                                                       pattern):
    _, _, uniq, merged, (p, m, v) = merged_case(dim, vocab, dim, n, pattern)
    lr_t = np.float32(0.01)
    want = jsa.sparse_adam_rows(
        jnp.asarray(p), jnp.asarray(m), jnp.asarray(v),
        jnp.asarray(uniq.numpy().astype(np.int32)), jnp.asarray(merged),
        lr_t, 0.9, 0.999, 1e-8, interpret=True)
    got = tsa.sparse_adam_rows_reference(
        torch.tensor(p), torch.tensor(m), torch.tensor(v), uniq, merged,
        torch.tensor([lr_t]), 0.9, 0.999, 1e-8)
    for name, g, w, old in zip("pmv", got, want, (p, m, v)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=name)
        touched = np.zeros(vocab, bool)
        touched[uniq.numpy()[uniq.numpy() < vocab]] = True
        np.testing.assert_array_equal(g.numpy()[~touched], old[~touched])


@pytest.mark.parametrize("vocab,dim,n", CASES)
@pytest.mark.parametrize("pattern", ["dups", "padded"])
def test_sgd_plain_version_matches_pallas_interpreter(vocab, dim, n,
                                                      pattern):
    _, _, uniq, merged, (p, _, _) = merged_case(dim + 1, vocab, dim, n,
                                                pattern)
    want = jsa.sparse_sgd_rows(
        jnp.asarray(p), jnp.asarray(uniq.numpy().astype(np.int32)),
        jnp.asarray(merged), np.float32(0.3), interpret=True)
    got = tsa.sparse_sgd_rows_reference(torch.tensor(p), uniq, merged,
                                        torch.tensor([0.3]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_padding_ids_never_write_row_v_minus_1():
    """Row V-1 is named by no id, only clamped to by the padding tail; the
    plain versions add -0.0 there, which keeps every bit, -0.0 included."""
    vocab, dim = 40, 6
    rng = np.random.RandomState(3)
    ids = torch.tensor(rng.randint(0, vocab - 1, 30).astype(np.int64))
    uniq, merged = tsparse.merge_rows(
        ids, torch.tensor(rng.randn(30, dim).astype(np.float32)), vocab)
    assert (uniq == vocab).any() and not (uniq == vocab - 1).any()
    tables = [torch.tensor(rng.randn(vocab, dim).astype(np.float32))
              for _ in range(3)]
    for t in tables:
        t[vocab - 1, ::2] = -0.0
    before = [t[vocab - 1].clone() for t in tables]
    tsa.sparse_adam_rows(*tables, uniq, merged, 0.01)
    tsa.sparse_sgd_rows(tables[0], uniq, merged, 0.5)
    for t, b in zip(tables, before):
        assert torch.equal(t[vocab - 1].view(torch.int32),
                           b.view(torch.int32))
    assert torch.signbit(tables[0][vocab - 1, ::2]).all()


def test_wrappers_update_in_place_and_check_their_inputs():
    _, _, uniq, merged, (p, m, v) = merged_case(0, 100, 4, 30)
    p, m, v = torch.tensor(p), torch.tensor(m), torch.tensor(v)
    a0, s0 = tsa.LAUNCHES_ADAM, tsa.LAUNCHES_SGD
    p0 = p.clone()
    out = tsa.sparse_adam_rows(p, m, v, uniq, merged, 1e-2)
    assert out[0] is p and out[1] is m and out[2] is v
    assert not torch.equal(p, p0)
    assert tsa.sparse_sgd_rows(p, uniq, merged, 1e-2) is p
    # the CPU route is the plain version: no kernel launch is counted
    assert (tsa.LAUNCHES_ADAM, tsa.LAUNCHES_SGD) == (a0, s0)
    with pytest.raises(TypeError):
        tsa.sparse_sgd_rows(p.double(), uniq, merged.double(), 1e-2)
    with pytest.raises(TypeError):
        tsa.sparse_sgd_rows(p, uniq.int(), merged, 1e-2)
    with pytest.raises(TypeError):
        tsa.sparse_sgd_rows(p, uniq, merged[:, :2], 1e-2)
    with pytest.raises(ValueError, match="contiguous"):
        tsa.sparse_adam_rows(p, m.t().contiguous().t(), v, uniq, merged, 1e-2)
    assert tsa.sparse_rows_supported(p, m, v)
    assert not tsa.sparse_rows_supported(p, m.double(), v)


@pytest.mark.parametrize("d,ptrs,width", [
    (10, (256, 512, 1024, 64), 2), (10, (256, 512, 1028, 64), 1),
    (10, (256, 512, 1024, 72), 2), (1, (256, 256), 1), (4, (256, 512), 4),
    (4, (256, 520), 2), (4, (260, 512), 1), (16, (4096, 48), 4),
    (16, (4096, 40), 2), (2, (16, 24), 2), (2, (16, 20), 1), (6, (16, 32), 2),
    (7, (16, 32), 1), (33, (256, 256), 1), (64, (16, 16, 16, 16), 4),
    (8, (16, 16), 4), (8, (16, 8), 2), (12, (48, 4), 1), (3, (16, 16), 1),
    (20, (32, 40), 2)])
def test_vector_width_follows_d_and_every_pointer(d, ptrs, width):
    """4 floats a load where D % 4 == 0 and every pointer lies on 16 bytes,
    2 where D is even and they lie on 8, else 1."""
    assert tsa.vector_width(d, *ptrs) == width


@pytest.mark.parametrize("d", [10, 1, 4])
def test_load_width_of_views_off_alignment(d):
    """Contiguous views one or two elements into a buffer narrow the width
    the wrapper hands the kernel; neither changes the route on the CPU,
    where the plain version runs."""
    def off(t, k):
        flat = torch.empty(t.numel() + k, dtype=t.dtype)
        return flat[k:].view(t.shape).copy_(t)

    _, _, uniq, merged, tables = merged_case(d, 100, d, 30)
    tables = [torch.tensor(t) for t in tables]
    base = tsa.load_width(tables, merged)
    assert base == (4 if d % 4 == 0 else 2 if d % 2 == 0 else 1)
    assert tsa.load_width([off(t, 1) for t in tables], merged) == 1
    assert tsa.load_width(tables, off(merged, 1)) == 1
    two = tsa.load_width([off(t, 2) for t in tables], merged)
    assert two == (2 if d % 2 == 0 else 1)
