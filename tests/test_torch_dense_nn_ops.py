"""The port's dense NN ops match the JAX package's.

``log_softmax``, the elementwise losses, ``group_norm``,
``instance_norm``, ``lrn``, ``data_norm``, ``affine_channel``,
``mean_iou`` and the two interpolations run through both registries on
the same ``RandomState`` inputs, forward and backward (``check_op`` of
``test_torch_dense_reduce_math``): elementwise outputs to 1e-6,
normalisations and reductions to 1e-5, gradients to 1e-5; bf16 (what
an op sees under ``amp.decorate``) to 2e-2 with the JAX package's dtype,
but for the gradients of the two normalisations (4e-2, below).
At a loss's kink both packages take the same subgradient.

Interpolation: without ``align_corners`` / ``align_mode`` (the JAX
package's layer writes neither) both centre at half pixels and agree
when enlarging by whole factors; with them the port follows Fluid's
``interpolate_op.h``, held to a per-pixel transcription of its loops.
"""

import numpy as np
import pytest

from test_torch_dense_reduce_math import (BF16, ELEMENTWISE, REDUCTION,
                                          check_op, randn)

IMG = (2, 8, 5, 6)


def labels01(*shape, seed=1):
    return np.random.RandomState(seed).randint(0, 2, shape).astype(
        np.float32)


def prob(*shape, seed=0):
    return np.random.RandomState(seed).uniform(0.05, 0.95, shape).astype(
        np.float32)


def away(x, kinks, d=0.05):
    for k in kinks:
        x = np.where(np.abs(x - k) < d, k + 2 * d, x)
    return x.astype(np.float32)


CASES = {
    "log_softmax": ("log_softmax", {"axis": -1},
                    lambda: {"X": randn(6, 11)}, {"Out": 1}, REDUCTION),
    "log_softmax_axis1": ("log_softmax", {"axis": 1},
                          lambda: {"X": randn(3, 7, 4)}, {"Out": 1},
                          REDUCTION),
    "sigmoid_cross_entropy_with_logits": (
        "sigmoid_cross_entropy_with_logits", {},
        lambda: {"X": away(randn(6, 5), [0.0]), "Label": labels01(6, 5)},
        {"Out": 1}, ELEMENTWISE),
    "sigmoid_xent_ignore_normalize": (
        "sigmoid_cross_entropy_with_logits",
        {"ignore_index": -1, "normalize": True},
        lambda: {"X": away(randn(6, 5), [0.0]), "Label": np.where(
            labels01(6, 5, seed=2) > 0, -1.0, labels01(6, 5)).astype(
                np.float32)}, {"Out": 1}, ELEMENTWISE),
    "sigmoid_xent_soft": (
        "sigmoid_cross_entropy_with_logits", {},
        lambda: {"X": away(randn(6, 5), [0.0]), "Label": prob(6, 5)},
        {"Out": 1}, ELEMENTWISE),
    "log_loss": ("log_loss", {"epsilon": 1e-4}, lambda: {
        "Predicted": prob(8, 1), "Labels": labels01(8, 1)}, {"Loss": 1},
        ELEMENTWISE),
    "huber_loss": ("huber_loss", {"delta": 0.8}, lambda: {
        "X": randn(8, 1), "Y": randn(8, 1, seed=1)},
        {"Out": 1, "Residual": 1}, ELEMENTWISE),
    "smooth_l1_loss": ("smooth_l1_loss", {"sigma": 1.5}, lambda: {
        "X": randn(6, 4), "Y": randn(6, 4, seed=1)}, {"Out": 1, "Diff": 1},
        REDUCTION),
    "smooth_l1_loss_weights": ("smooth_l1_loss", {"sigma": 0.7}, lambda: {
        "X": randn(6, 4), "Y": randn(6, 4, seed=1),
        "InsideWeight": prob(6, 4, seed=2),
        "OutsideWeight": prob(6, 4, seed=3)}, {"Out": 1, "Diff": 1},
        REDUCTION),
    "hinge_loss": ("hinge_loss", {}, lambda: {
        "Logits": randn(8, 1), "Labels": labels01(8, 1)}, {"Loss": 1},
        ELEMENTWISE),
    "rank_loss": ("rank_loss", {}, lambda: {
        "Label": labels01(8, 1), "Left": randn(8, 1),
        "Right": randn(8, 1, seed=2)}, {"Out": 1}, ELEMENTWISE),
    "bpr_loss": ("bpr_loss", {}, lambda: {
        "X": randn(6, 9), "Label": np.random.RandomState(1).randint(
            0, 9, (6, 1)).astype(np.int64)}, {"Y": 1}, REDUCTION),
    "margin_rank_loss": ("margin_rank_loss", {"margin": 0.1}, lambda: {
        "Label": np.where(labels01(8, 1) > 0, 1.0, -1.0).astype(np.float32),
        "X1": randn(8, 1), "X2": randn(8, 1, seed=2)},
        {"Out": 1, "Activated": 1}, ELEMENTWISE),
    "group_norm": ("group_norm", {"groups": 4, "epsilon": 1e-5}, lambda: {
        "X": randn(*IMG), "Scale": randn(8, seed=1),
        "Bias": randn(8, seed=2)},
        {"Y": 1, "Mean": 1, "Variance": 1}, REDUCTION),
    "group_norm_noaffine": ("group_norm", {"groups": 2},
                            lambda: {"X": randn(*IMG)},
                            {"Y": 1, "Mean": 1, "Variance": 1}, REDUCTION),
    "instance_norm": ("instance_norm", {"epsilon": 1e-5}, lambda: {
        "X": randn(*IMG), "Scale": randn(8, seed=1),
        "Bias": randn(8, seed=2)}, {"Y": 1}, REDUCTION),
    "instance_norm_noaffine": ("instance_norm", {},
                               lambda: {"X": randn(*IMG)}, {"Y": 1},
                               REDUCTION),
    "lrn": ("lrn", {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75},
            lambda: {"X": randn(*IMG)}, {"Out": 1, "MidOut": 1}, REDUCTION),
    "lrn_n3": ("lrn", {"n": 3, "k": 1.0, "alpha": 0.1, "beta": 0.5},
               lambda: {"X": randn(*IMG)}, {"Out": 1, "MidOut": 1},
               REDUCTION),
    "data_norm": ("data_norm", {}, lambda: {
        "X": randn(6, 4), "BatchSize": np.full(4, 10.0, np.float32),
        "BatchSum": randn(4, seed=1) * 10,
        "BatchSquareSum": 20 + np.abs(randn(4, seed=2)) * 10},
        {"Y": 1, "Means": 1, "Scales": 1}, REDUCTION),
    "affine_channel": ("affine_channel", {}, lambda: {
        "X": randn(*IMG), "Scale": randn(8, seed=1),
        "Bias": randn(8, seed=2)}, {"Out": 1}, ELEMENTWISE),
    "affine_channel_nhwc": ("affine_channel", {"data_layout": "NHWC"},
                            lambda: {"X": randn(2, 5, 6, 8),
                                     "Scale": randn(8, seed=1),
                                     "Bias": randn(8, seed=2)}, {"Out": 1},
                            ELEMENTWISE),
    "mean_iou": ("mean_iou", {"num_classes": 5}, lambda: {
        "Predictions": np.random.RandomState(1).randint(0, 5, (40,)),
        "Labels": np.random.RandomState(2).randint(0, 5, (40,))},
        {"OutMeanIou": 1}, REDUCTION),
    "mean_iou_absent_class": ("mean_iou", {"num_classes": 6}, lambda: {
        "Predictions": np.random.RandomState(1).randint(0, 4, (8, 5)),
        "Labels": np.random.RandomState(2).randint(0, 4, (8, 5))},
        {"OutMeanIou": 1}, REDUCTION),
    "bilinear_interp_2x": ("bilinear_interp", {"out_h": 10, "out_w": 12},
                           lambda: {"X": randn(*IMG)}, {"Out": 1},
                           REDUCTION),
    "bilinear_interp_scale3": ("bilinear_interp", {"scale": 3.0},
                               lambda: {"X": randn(*IMG)}, {"Out": 1},
                               REDUCTION),
    "nearest_interp_2x": ("nearest_interp", {"out_h": 10, "out_w": 12},
                          lambda: {"X": randn(*IMG)}, {"Out": 1},
                          REDUCTION),
    "nearest_interp_scale3": ("nearest_interp", {"scale": 3.0},
                              lambda: {"X": randn(*IMG)}, {"Out": 1},
                              REDUCTION),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_nn_op_matches_jax(case):
    op_type, attrs, inputs, outs, tol = CASES[case]
    check_op(op_type, attrs, inputs(), outs, tol=tol)


BF16_CASES = ("log_softmax", "sigmoid_cross_entropy_with_logits",
              "huber_loss", "smooth_l1_loss", "hinge_loss", "rank_loss",
              "bpr_loss", "margin_rank_loss", "log_loss", "group_norm",
              "instance_norm")


# the bf16 gradient of a normalisation is a difference of bf16-rounded
# terms, each package rounding its own intermediates: read 3.3e-2
# (group_norm) and 2.2e-2 (instance_norm) of 1 + |x| apart, each package
# within 2.8e-2 of a float64 run on the same bf16 inputs; every other
# case's gradient reads at most 6.9e-3 (log_softmax)
BF16_NORM_GRAD = (4e-2, 4e-2)


@pytest.mark.parametrize("case", BF16_CASES)
def test_nn_op_bf16_matches_jax(case):
    import jax.numpy as jnp

    op_type, attrs, inputs, outs, _ = CASES[case]
    inp = {k: v.astype(jnp.bfloat16) if v.dtype == np.float32 else v
           for k, v in inputs().items()}
    check_op(op_type, attrs, inp, outs, tol=BF16,
             grad_tol=BF16_NORM_GRAD if case.endswith("_norm") else BF16)


KINKS = {
    # each loss exactly at its kink, where JAX's autodiff takes one
    # subgradient (jnp.maximum: half at the tie; |x|: +1 at 0; a where on
    # <= or <: the branch the comparison picks)
    "sigmoid_cross_entropy_with_logits": lambda: {
        "X": np.zeros((4, 3), np.float32), "Label": labels01(4, 3)},
    "hinge_loss": lambda: {
        "Logits": np.array([[1.0], [-1.0], [0.5]], np.float32),
        "Labels": np.array([[1.0], [0.0], [1.0]], np.float32)},
    "margin_rank_loss": lambda: {
        "Label": np.array([[1.0], [-1.0]], np.float32),
        "X1": np.array([[0.6], [0.2]], np.float32),
        "X2": np.array([[0.5], [0.1]], np.float32)},
    "huber_loss": lambda: {
        "X": np.array([[0.0], [1.0], [0.0]], np.float32),
        "Y": np.array([[1.0], [1.0], [-1.0]], np.float32)},
    "smooth_l1_loss": lambda: {
        "X": np.array([[1.0, 0.0]], np.float32),
        "Y": np.array([[0.0, 0.0]], np.float32)},
}


@pytest.mark.parametrize("op_type", sorted(KINKS))
def test_loss_kinks_take_jax_subgradients(op_type):
    attrs = {"margin": 0.1} if op_type == "margin_rank_loss" else {}
    outs = [v[3] for v in CASES.values() if v[0] == op_type][0]
    check_op(op_type, attrs, KINKS[op_type](), outs)


# -- interpolation: Fluid's rules -------------------------------------------


def fluid_interp(x, out_h, out_w, nearest, align_corners, align_mode):
    """A transcription of Fluid 1.3's ``interpolate_op.h`` loops
    (BilinearInterpolation, NearestNeighborInterpolate) in float64."""
    n, c, in_h, in_w = x.shape

    def ratio(i, o):
        if align_corners:
            return (i - 1) / (o - 1) if o > 1 else 0.0
        return i / o

    rh, rw = ratio(in_h, out_h), ratio(in_w, out_w)
    out = np.zeros((n, c, out_h, out_w))
    flag = align_mode == 0 and not align_corners
    for k in range(out_h):
        for m in range(out_w):
            if nearest:
                ik = int(rh * k + 0.5) if align_corners else int(rh * k)
                im = int(rw * m + 0.5) if align_corners else int(rw * m)
                out[:, :, k, m] = x[:, :, ik, im]
                continue
            yn = int(rh * (k + 0.5) - 0.5) if flag else int(rh * k)
            yn = max(yn, 0)
            ys = min(yn + 1, in_h - 1)
            sy = max(rh * (k + 0.5) - 0.5, 0.0)
            dn = sy - yn if flag else rh * k - yn
            xn = int(rw * (m + 0.5) - 0.5) if flag else int(rw * m)
            xn = max(xn, 0)
            xs = min(xn + 1, in_w - 1)
            sx = max(rw * (m + 0.5) - 0.5, 0.0)
            dw = sx - xn if flag else rw * m - xn
            out[:, :, k, m] = (
                x[:, :, yn, xn] * (1 - dn) * (1 - dw)
                + x[:, :, ys, xn] * dn * (1 - dw)
                + x[:, :, yn, xs] * (1 - dn) * dw
                + x[:, :, ys, xs] * dn * dw)
    return out


FLUID_RULES = [(nearest, corners, mode, size)
               for nearest in (False, True)
               for corners, mode in ((True, 1), (False, 0), (False, 1))
               for size in ((9, 11), (3, 4))
               if not (nearest and mode == 0)]


@pytest.mark.parametrize("nearest,corners,mode,size", FLUID_RULES)
def test_interp_follows_fluid_rules(nearest, corners, mode, size):
    import types

    import torch

    from paddle_tpu_torch.core import registry as treg

    x = randn(*IMG)
    op_type = "nearest_interp" if nearest else "bilinear_interp"
    op = types.SimpleNamespace(
        type=op_type, block=None, inputs={"X": ["X"]},
        outputs={"Out": ["Out"]},
        attrs={"out_h": size[0], "out_w": size[1], "align_corners": corners,
               "align_mode": mode})
    env = {"X": torch.tensor(x, dtype=torch.float64)}
    treg.get_op_impl(op_type)(treg.OpContext(op, env, None))
    want = fluid_interp(x.astype(np.float64), size[0], size[1], nearest,
                        corners, mode)
    np.testing.assert_allclose(env["Out"].numpy(), want, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("before", [(False, False), (True, False),
                                    (True, True)])
def test_lookup_backward_restores_the_deterministic_setting(before):
    """The dense lookup's table gradient turns torch's deterministic
    setting on for its own call only: the setting found before holds
    after, also when backwards on four threads overlap."""
    import threading

    import torch

    from paddle_tpu_torch.ops.nn_ops import _Lookup

    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    try:
        w = torch.tensor(randn(6, 4))
        ids = torch.tensor([0, 3, 3, 5])
        want = torch.zeros(6, 4).index_add_(0, ids, torch.ones(4, 4))

        def grads(out):
            for _ in range(20):
                leaf = w.clone().requires_grad_(True)
                out.append(torch.autograd.grad(
                    _Lookup.apply(leaf, ids), leaf, torch.ones(4, 4))[0])

        results = [[] for _ in range(4)]
        threads = [threading.Thread(target=grads, args=(r,))
                   for r in results]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(torch.equal(g, want) for r in results for g in r)
        assert (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled()) \
            == before
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
