"""The port's SSD path matches the JAX package's: ``bipartite_match``
(``bipartite`` and ``per_prediction``), ``target_assign`` (with
``NegMask``), ``mine_hard_examples`` and ``multiclass_nms`` (with
``nms_eta`` < 1 and either background), each on inputs with exact ties,
whose order must follow the JAX package's (lower index first); then
``ssd_loss``'s value and its gradients to the location and confidence
inputs, ``detection_output``, and a two-map SSD built from
``multi_box_head`` trained 3 Momentum steps from the JAX package's
startup weights. Discrete outputs are identical, floats agree to 1e-5."""

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from test_torch_gradients import assert_rows, run_both
from torch_detection_util import boxes, check_det


def _tied_dist(rng, b, n, m):
    """IoU-like distances on a coarse grid (many exact ties), one padding
    row (all zero) in the first image."""
    d = rng.randint(0, 6, (b, n, m)).astype(np.float32) / 5.0
    d[0, -1] = 0.0
    return d


@pytest.mark.parametrize("match_type", ("bipartite", "per_prediction"))
def test_bipartite_match_with_ties(match_type):
    rng = np.random.RandomState(0)
    d = _tied_dist(rng, 3, 4, 9)
    attrs = {"match_type": match_type, "dist_threshold": 0.5}
    outs = {"ColToRowMatchIndices": 1, "ColToRowMatchDist": 1}
    check_det("bipartite_match", attrs, {"DistMat": d}, outs, diff=[])
    check_det("bipartite_match", attrs, {"DistMat": d[1]}, outs, diff=[])
    # more rows than columns: the loop stops at min(N, M)
    check_det("bipartite_match", attrs, {"DistMat": _tied_dist(rng, 2, 7, 3)},
              outs, diff=[])


def test_target_assign_with_neg_mask():
    rng = np.random.RandomState(1)
    b, ng, p, m = 2, 3, 4, 8
    match = rng.randint(-1, ng, (b, m)).astype(np.int32)
    neg = ((match < 0) & (rng.rand(b, m) < 0.6)).astype(np.int32)
    x4 = rng.randn(b, ng, p, 4).astype(np.float32)
    outs = {"Out": 1, "OutWeight": 1}
    check_det("target_assign", {}, {"X": x4, "MatchIndices": match}, outs)
    x4p = rng.randn(b, ng, m, 4).astype(np.float32)  # P = M: per-prior rows
    check_det("target_assign", {"mismatch_value": 0.0},
              {"X": x4p, "MatchIndices": match}, outs)
    labels = rng.randint(1, 5, (b, ng, 1)).astype(np.int64)
    check_det("target_assign", {"mismatch_value": 0},
              {"X": labels, "MatchIndices": match, "NegMask": neg}, outs)


@pytest.mark.parametrize("ratio", (1.0, 3.0))
def test_mine_hard_examples_with_tied_losses(ratio):
    rng = np.random.RandomState(2)
    b, p = 3, 20
    loss = (rng.randint(0, 4, (b, p)) / 2.0).astype(np.float32)
    match = np.where(rng.rand(b, p) < 0.2, rng.randint(0, 3, (b, p)), -1)
    dist = rng.rand(b, p).astype(np.float32)
    attrs = {"neg_pos_ratio": ratio, "neg_dist_threshold": 0.5}
    outs = {"NegMask": 1, "UpdatedMatchIndices": 1}
    got = check_det("mine_hard_examples", attrs,
                    {"ClsLoss": loss, "MatchIndices": match.astype(np.int32),
                     "MatchDist": dist}, outs, diff=[])
    assert got["NegMask"].sum() > 0
    check_det("mine_hard_examples", attrs,
              {"ClsLoss": loss, "MatchIndices": match.astype(np.int32)},
              outs, diff=[])


@pytest.mark.parametrize("eta,bg", ((1.0, 0), (0.7, 0), (1.0, -1)))
def test_multiclass_nms_with_ties(eta, bg):
    rng = np.random.RandomState(3)
    b, c, m = 2, 4, 30
    bb = boxes(rng, m, (b,), min_wh=0.1)
    bb[:, 5] = bb[:, 4]  # duplicate boxes
    scores = (rng.randint(0, 8, (b, c, m)) / 8.0).astype(np.float32)
    attrs = {"background_label": bg, "score_threshold": 0.1, "nms_top_k": 12,
             "nms_threshold": 0.6, "nms_eta": eta, "keep_top_k": 10,
             "normalized": True}
    got = check_det("multiclass_nms", attrs, {"BBoxes": bb, "Scores": scores},
                    {"Out": 1, "Length": 1}, diff=[])
    assert (got["Length"] > 0).all()
    # no nms_top_k / keep_top_k: every class and candidate
    check_det("multiclass_nms", dict(attrs, nms_top_k=-1, keep_top_k=-1),
              {"BBoxes": bb, "Scores": scores}, {"Out": 1, "Length": 1},
              diff=[])


def _ssd_inputs(rng, b=2, p=12, c=4, ng=3):
    prior = boxes(rng, p, min_wh=0.15)
    gt = boxes(rng, ng, (b,), min_wh=0.15)
    gt[0, -1] = 0.0  # a padding row
    lab = rng.randint(1, c, (b, ng, 1)).astype(np.int64)
    return {"loc": (rng.randn(b, p, 4) * 0.3).astype(np.float32),
            "conf": rng.randn(b, p, c).astype(np.float32),
            "gt_box": gt, "gt_label": lab,
            "prior": prior,
            "prior_var": np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (p, 1))}


def _ssd_loss_program(fluid, feed):
    p, c = feed["conf"].shape[1:]
    ng = feed["gt_box"].shape[1]
    loc = fluid.layers.data("loc", shape=[p, 4])
    conf = fluid.layers.data("conf", shape=[p, c])
    gt_box = fluid.layers.data("gt_box", shape=[ng, 4])
    gt_label = fluid.layers.data("gt_label", shape=[ng, 1], dtype="int64")
    prior = fluid.layers.data("prior", shape=[p, 4], append_batch_size=False)
    prior_var = fluid.layers.data("prior_var", shape=[p, 4],
                                  append_batch_size=False)
    for v in (loc, conf):
        v.stop_gradient = False
    loss = fluid.layers.ssd_loss(loc, conf, gt_box, gt_label, prior, prior_var)
    total = fluid.layers.reduce_sum(loss)
    return [loss] + list(fluid.gradients(total, [loc, conf]))


def test_ssd_loss_value_and_gradients():
    feed = _ssd_inputs(np.random.RandomState(4))
    got, want = run_both(lambda fluid: _ssd_loss_program(fluid, feed), feed)
    assert_rows(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(got[0][2]).sum() > 0  # the confidence gradient


def test_detection_output_matches():
    rng = np.random.RandomState(5)
    feed = _ssd_inputs(rng, b=2, p=16, c=5)
    feed["conf"] = (rng.randint(0, 6, feed["conf"].shape) / 2.0).astype(np.float32)

    def build(fluid):
        p, c = feed["conf"].shape[1:]
        loc = fluid.layers.data("loc", shape=[p, 4])
        conf = fluid.layers.data("conf", shape=[p, c])
        prior = fluid.layers.data("prior", shape=[p, 4], append_batch_size=False)
        var = fluid.layers.data("prior_var", shape=[p, 4], append_batch_size=False)
        out, length = fluid.layers.detection_output(
            loc, conf, prior, var, nms_threshold=0.45, nms_top_k=10,
            keep_top_k=8, score_threshold=0.01, return_length=True)
        return [out, length]

    got, want = run_both(build, {k: feed[k] for k in
                                 ("loc", "conf", "prior", "prior_var")})
    np.testing.assert_array_equal(got[0][1], want[0][1])
    np.testing.assert_array_equal(got[0][0][..., 0], want[0][0][..., 0])
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-5, atol=1e-5)


def _tiny_ssd(fluid, c=4, ng=3):
    img = fluid.layers.data("img", shape=[3, 32, 32])
    gt_box = fluid.layers.data("gt_box", shape=[ng, 4])
    gt_label = fluid.layers.data("gt_label", shape=[ng, 1], dtype="int64")
    f1 = fluid.layers.conv2d(img, 8, 3, stride=4, padding=1, act="relu")   # 8x8
    f2 = fluid.layers.conv2d(f1, 8, 3, stride=2, padding=1, act="relu")    # 4x4
    locs, confs, prior, var = fluid.layers.multi_box_head(
        [f1, f2], img, base_size=32, num_classes=c,
        aspect_ratios=[[2.0], [2.0, 3.0]], min_sizes=[6.0, 14.0],
        max_sizes=[14.0, 24.0], steps=[4.0, 8.0], flip=True, offset=0.5)
    loss = fluid.layers.reduce_mean(fluid.layers.ssd_loss(
        locs, confs, gt_box, gt_label, prior, var))
    fluid.optimizer.Momentum(1e-2, 0.9).minimize(loss)
    return [loss, prior]


def test_tiny_ssd_trains_like_the_jax_package():
    rng = np.random.RandomState(6)
    b, ng = 2, 3
    feed = {"img": rng.randn(b, 3, 32, 32).astype(np.float32),
            "gt_box": boxes(rng, ng, (b,), min_wh=0.2),
            "gt_label": rng.randint(1, 4, (b, ng, 1)).astype(np.int64)}
    feed["gt_box"][1, -1] = 0.0
    got, want = run_both(_tiny_ssd, feed, steps=3)
    # 8·8·(4 + 1) + 4·4·(6 + 1) priors: the count follows the op's rule
    assert got[0][1].shape == (8 * 8 * 4 + 4 * 4 * 6, 4)
    assert_rows(got, want, rtol=1e-5, atol=1e-5)
    assert got[2][0] < got[0][0]


def test_mining_other_than_max_negative_is_refused():
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.layers.data("x", shape=[4, 4])
        with pytest.raises(NotImplementedError):
            tfluid.layers.ssd_loss(x, x, x, x, x, mining_type="hard_example")
