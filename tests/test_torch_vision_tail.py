"""The port's vision-tail ops match the JAX package's.

``spp`` (max and average pyramids over sizes the bins do not divide),
``max_pool2d_with_index`` (strides, padding, ties), ``unpool`` of its
indices, ``grid_sampler`` (points outside the image, the JAX op's corner
convention) and ``psroi_pool`` run through both registries
(``check_op``) on the same ``RandomState`` inputs, forward and gradient:
float outputs and gradients to 1e-5, the int32 index masks identical.
"""

import numpy as np
import pytest

from test_torch_dense_reduce_math import check_op, randn

TOL = (1e-5, 1e-5)


@pytest.mark.parametrize("ptype", ("max", "avg"))
def test_spp_matches_jax(ptype):
    check_op("spp", {"pyramid_height": 3, "pooling_type": ptype},
             {"X": randn(2, 3, 7, 10)}, {"Out": 1}, tol=TOL, grad_tol=TOL)


POOL_CASES = {
    "2x2": dict(ksize=[2, 2], strides=[2, 2], paddings=[0, 0]),
    "3x2_s2_p1": dict(ksize=[3, 2], strides=[2, 1], paddings=[1, 1]),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_max_pool2d_with_index_matches_jax(case):
    check_op("max_pool2d_with_index", POOL_CASES[case],
             {"X": randn(2, 3, 9, 8, seed=1)}, {"Out": 1, "Mask": 1},
             tol=TOL, grad_tol=TOL)


def test_max_pool2d_with_index_ties_take_the_first():
    x = np.random.RandomState(2).randint(0, 2, (2, 2, 6, 6)).astype(
        np.float32)
    check_op("max_pool2d_with_index", POOL_CASES["2x2"], {"X": x},
             {"Out": 1, "Mask": 1}, tol=TOL, grad_tol=TOL)


@pytest.mark.parametrize("sized", (False, True))
def test_unpool_of_pool_indices_matches_jax(sized):
    from test_torch_dense_reduce_math import run_port

    x = randn(2, 3, 8, 6, seed=3)
    got, _ = run_port("max_pool2d_with_index", POOL_CASES["2x2"], {"X": x},
                      {"Out": 1, "Mask": 1}, [], {})
    attrs = {"ksize": [2, 2], "strides": [2, 2]}
    if sized:
        attrs["unpooled_size"] = [8, 6]
    out, _ = check_op("unpool", attrs,
                      {"X": got["Out"].numpy(),
                       "Indices": got["Mask"].numpy()},
                      {"Out": 1}, tol=TOL, grad_tol=TOL, diff=["X"])
    # each window's maximum back at its place, zeros elsewhere
    back = out["Out"].detach().numpy()
    assert ((back == 0) | (back == x)).all()
    assert (back != 0).sum() == 2 * 3 * 4 * 3


def test_grid_sampler_matches_jax():
    rng = np.random.RandomState(4)
    x = randn(2, 3, 5, 7, seed=5)
    # a third of the points fall outside [-1, 1]
    grid = (rng.rand(2, 4, 6, 2) * 3.0 - 1.5).astype(np.float32)
    grid[0, 0, 0] = (-1.0, -1.0)          # the corner pixels' centres
    grid[0, 0, 1] = (1.0, 1.0)
    got, _ = check_op("grid_sampler", {}, {"X": x, "Grid": grid},
                      {"Output": 1}, tol=TOL, grad_tol=TOL)
    out = got["Output"].detach().numpy()
    np.testing.assert_allclose(out[0, :, 0, 0], x[0, :, 0, 0], rtol=1e-6)
    np.testing.assert_allclose(out[0, :, 0, 1], x[0, :, -1, -1], rtol=1e-6)


def test_psroi_pool_matches_jax():
    rng = np.random.RandomState(6)
    oc, ph, pw = 2, 3, 2
    x = randn(2, oc * ph * pw, 12, 10, seed=7)
    rois = np.array([[0, 0, 9, 11], [2, 3, 6, 9], [1.4, 0.6, 3.5, 2.5],
                     [5, 5, 5, 5]], np.float32)
    check_op("psroi_pool", {"output_channels": oc, "pooled_height": ph,
                            "pooled_width": pw, "spatial_scale": 0.5},
             {"X": x, "ROIs": rois,
              "BatchId": rng.randint(0, 2, 4).astype(np.int64)},
             {"Out": 1}, tol=TOL, grad_tol=TOL, diff=["X"])
