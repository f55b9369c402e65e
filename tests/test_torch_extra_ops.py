"""The port's remaining general ops match the JAX package's.

Each op runs through both registries (``check_op``) on the same
``RandomState`` inputs, forward and gradient: float outputs and
gradients to 1e-5, integer outputs identical, dtypes included; ``hash``
bit for bit against the JAX op's uint32 arithmetic, including ids past
2^31 and negative ids. The random ops (``sampling_id``, ``random_crop``)
draw from the port's own generator: their law, bounds and repeat from
the seed are checked, and ``random_crop`` under ``is_test`` (the centre)
against the JAX op. ``tree_conv`` builds its patches from a host copy of
the edges in both packages.
"""

import numpy as np
import pytest
import torch

from test_torch_dense_reduce_math import check_op, randn
from test_torch_sampled_losses import jax_rng, port_run

TOL = (1e-5, 1e-5)


def test_add_position_encoding_matches_jax():
    for d in (8, 7):
        check_op("add_position_encoding", {"alpha": 0.5, "beta": 2.0},
                 {"X": randn(2, 6, d)}, {"Out": 1}, tol=TOL, grad_tol=TOL)


@pytest.mark.parametrize("as_input", (False, True))
def test_affine_grid_matches_jax(as_input):
    theta = randn(3, 2, 3, seed=1)
    inputs, attrs = {"Theta": theta}, {}
    if as_input:
        inputs["OutputShape"] = np.array([3, 1, 4, 5], np.int32)
    else:
        attrs["output_shape"] = [3, 1, 4, 5]
    check_op("affine_grid", attrs, inputs, {"Output": 1}, tol=TOL,
             grad_tol=TOL, diff=["Theta"])


def test_modified_huber_loss_matches_jax():
    x = randn(20, 1, seed=2, scale=2.0)
    x[np.abs(np.abs(x) - 1.0) < 0.05] += 0.2   # off the kinks at z = ±1
    y = np.random.RandomState(3).randint(0, 2, (20, 1)).astype(np.float32)
    check_op("modified_huber_loss", {}, {"X": x, "Y": y},
             {"IntermediateVal": 1, "Out": 1}, tol=TOL, grad_tol=TOL,
             diff=["X"])


def test_teacher_student_sigmoid_loss_matches_jax():
    x = randn(16, 1, seed=4)
    label = np.array([-2, -1, 0.3, 0.0, 1.0, 1.7, -2, 0.9] * 2,
                     np.float32)[:, None]
    check_op("teacher_student_sigmoid_loss", {}, {"X": x, "Label": label},
             {"Y": 1}, tol=TOL, grad_tol=TOL, diff=["X"])


def test_sampling_id_draws_the_row_law():
    probs = np.array([[0.1, 0.6, 0.0, 0.3]] * 8000, np.float32)
    got, _ = port_run("sampling_id", {}, {"X": probs}, {"Out": 1}, [], None,
                      seed=2)
    again, _ = port_run("sampling_id", {}, {"X": probs}, {"Out": 1}, [],
                        None, seed=2)
    ids = got["Out"].numpy()
    assert got["Out"].dtype == torch.int32 and torch.equal(got["Out"],
                                                           again["Out"])
    freq = np.bincount(ids, minlength=4) / ids.size
    assert freq[2] == 0
    np.testing.assert_allclose(freq, probs[0], atol=5 * np.sqrt(
        0.25 / ids.size))


def test_random_crop_offsets_and_the_test_mode_centre():
    x = randn(2, 3, 9, 7, seed=5)
    attrs = {"shape": [4, 5]}
    starts = set()
    for seed in range(40):
        got, _ = port_run("random_crop", attrs, {"X": x}, {"Out": 1}, [],
                          None, seed=seed)
        out = got["Out"].numpy()
        hits = [(i, j) for i in range(6) for j in range(3)
                if np.array_equal(out, x[:, :, i:i + 4, j:j + 5])]
        assert len(hits) == 1
        starts.add(hits[0])
    assert len(starts) > 8     # offsets over the whole [0, 5] x [0, 2]
    with jax_rng():
        check_op("random_crop", dict(attrs, is_test=True), {"X": x},
                 {"Out": 1}, tol=TOL, grad_tol=TOL)


@pytest.mark.parametrize("dim,iters", ((0, 1), (1, 3)))
def test_spectral_norm_matches_jax(dim, iters):
    rng = np.random.RandomState(6)
    w = randn(4, 3, 2, seed=7)
    h = w.shape[dim]
    inputs = {"Weight": w, "U": rng.randn(h).astype(np.float32),
              "V": rng.randn(w.size // h).astype(np.float32)}
    check_op("spectral_norm", {"dim": dim, "power_iters": iters},
             inputs, {"Out": 1, "UOut": 1, "VOut": 1}, tol=TOL,
             grad_tol=TOL, diff=["Weight"])


def test_conv_shift_matches_jax():
    check_op("conv_shift", {}, {"X": randn(3, 8, seed=8),
                                "Y": randn(3, 5, seed=9)}, {"Out": 1},
             tol=TOL, grad_tol=TOL)


def test_similarity_focus_matches_jax():
    # a mask: no gradient reaches X
    check_op("similarity_focus", {"axis": 1, "indexes": [0, 2]},
             {"X": randn(2, 4, 5, 6, seed=10)}, {"Out": 1}, tol=TOL, diff=[])


@pytest.mark.parametrize("with_length", (False, True))
def test_fused_embedding_seq_pool_matches_jax(with_length):
    rng = np.random.RandomState(11)
    inputs = {"W": randn(12, 4, seed=12),
              "Ids": rng.randint(0, 12, (5, 7, 1)).astype(np.int64)}
    inputs["Ids"][0, :3] = 3              # a repeated id
    if with_length:
        inputs["Length"] = np.array([7, 2, 0, 5, 1], np.int64)
    check_op("fused_embedding_seq_pool", {}, inputs, {"Out": 1}, tol=TOL,
             grad_tol=TOL, diff=["W"])


def test_max_pool3d_with_index_matches_jax():
    check_op("max_pool3d_with_index", {"ksize": [2, 2, 2],
                                       "strides": [2, 1, 2]},
             {"X": randn(2, 2, 5, 4, 6, seed=13)}, {"Out": 1, "Mask": 1},
             tol=TOL, grad_tol=TOL)


@pytest.mark.parametrize("dtype", ("float32", "int32"))
def test_fill_matches_jax(dtype):
    check_op("fill", {"shape": [2, 3], "dtype": dtype,
                      "value": [1, 2, 3, 4, 5, 6]}, {}, {"Out": 1})


def test_tree_conv_matches_jax():
    # two trees: a root with three children, one of which has two; a chain
    edges = np.zeros((2, 6, 2), np.int64)
    edges[0, :5] = [[1, 2], [1, 3], [1, 4], [3, 5], [3, 6]]
    edges[1, :3] = [[1, 2], [2, 3], [3, 4]]
    check_op("tree_conv", {"max_depth": 3},
             {"NodesVector": randn(2, 7, 4, seed=14), "EdgeSet": edges,
              "Filter": randn(4, 3, 2, 3, seed=15)},
             {"Out": 1}, tol=TOL, grad_tol=TOL,
             diff=["NodesVector", "Filter"])


@pytest.mark.parametrize("num_hash,mod_by", ((1, 100000), (3, 1 << 30)))
def test_hash_matches_jax_bit_for_bit(num_hash, mod_by):
    rng = np.random.RandomState(16)
    ids = rng.randint(-2 ** 31, 2 ** 31 - 1, (50, 4)).astype(np.int64)
    ids[0] = [0, 1, -1, 2 ** 31 - 1]
    check_op("hash", {"num_hash": num_hash, "mod_by": mod_by},
             {"X": ids.astype(np.int32)}, {"Out": 1})


def test_the_port_lacks_only_the_parallel_ops():
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core.registry import registered_ops

    ported = set(registered_ops())
    assert len(ported) == 294 and ported <= set(jreg.registered_ops())
    left = {}
    for name in set(jreg.registered_ops()) - ported:
        module = jreg.get_op_impl(name).__module__.split(".")
        left.setdefault(module[-1] if module[1] == "ops" else module[1],
                        set()).add(name)
    assert {k: len(v) for k, v in left.items()} == {"parallel": 2}
    assert left["parallel"] == {"ring_attention", "shard_constraint"}
