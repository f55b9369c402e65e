"""The port's RoI, YOLOv3 and two-stage ops match the JAX package's:
``roi_align``, ``roi_pool`` and ``roi_perspective_transform`` (forward
and the gradient to X, with ``BatchId``), ``yolov3_loss`` (forward and
gradient, with padding rows and out-of-range padding labels),
``generate_proposals``, ``rpn_target_assign``,
``generate_proposal_labels`` and ``generate_mask_labels`` (identical at
``use_random=False``; at ``True`` the port's own draw keeps the counts,
eligibility and fg/bg split), and ``detection_map`` against the JAX op
and ``metrics.DetectionMAP`` of both packages. The RoI backwards sum
through ``segment_sum``: two runs give the same bits."""

import numpy as np
import pytest
import torch

import paddle_tpu.metrics as jmetrics
import paddle_tpu_torch.metrics as tmetrics
from torch_detection_util import boxes, check_det, run_jax, run_port


def _feat_rois(seed, n=2, c=3, h=9, w=11, r=5, scale=0.5):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c, h, w).astype(np.float32)
    rois = boxes(rng, r, hi=2 * min(h, w) - 2, min_wh=0.1)
    bid = rng.randint(0, n, (r,)).astype(np.int32)
    return x, rois, bid


@pytest.mark.parametrize("sampling", (-1, 3))
def test_roi_align_forward_and_gradient(sampling):
    x, rois, bid = _feat_rois(0)
    attrs = {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5,
             "sampling_ratio": sampling}
    check_det("roi_align", attrs, {"X": x, "ROIs": rois, "BatchId": bid},
              {"Out": 1}, diff=["X"])
    check_det("roi_align", attrs, {"X": x, "ROIs": rois}, {"Out": 1},
              diff=["X"])


def test_roi_pool_forward_and_gradient():
    x, rois, bid = _feat_rois(1)
    x = np.round(x * 2) / 2  # ties inside the bins
    attrs = {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5}
    check_det("roi_pool", attrs, {"X": x, "ROIs": rois, "BatchId": bid},
              {"Out": 1}, diff=["X"])


def test_roi_perspective_transform_forward_and_gradient():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 10, 12).astype(np.float32)
    quads = np.array([[1, 1, 9, 2, 10, 8, 2, 7],
                      [0, 0, 11, 0, 11, 9, 0, 9],
                      [3, 2, 6, 1, 8, 6, -2, 11]], np.float32)
    attrs = {"transformed_height": 4, "transformed_width": 5,
             "spatial_scale": 1.0}
    check_det("roi_perspective_transform", attrs,
              {"X": x, "ROIs": quads, "BatchId": np.int32([0, 1, 1])},
              {"Out": 1}, diff=["X"])


def test_roi_backward_is_the_same_on_every_run():
    x, rois, bid = _feat_rois(3, r=12)
    rois[4:8] = rois[0]  # the same taps read again
    grads = []
    for _ in range(2):
        env, got = run_port("roi_align", {"pooled_height": 2, "pooled_width": 2},
                            {"X": x, "ROIs": rois, "BatchId": bid}, {"Out": 1},
                            diff=["X"])
        g, = torch.autograd.grad(got["Out"].sum(), env["X"])
        grads.append(g)
    assert torch.equal(grads[0], grads[1])


ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]


@pytest.mark.parametrize("mask", ([0, 1, 2], [3, 4, 5]))
def test_yolov3_loss_forward_and_gradient(mask):
    rng = np.random.RandomState(4)
    n, c, h, w, nb = 2, 3, 5, 6, 6
    x = (rng.randn(n, len(mask) * (5 + c), h, w) * 0.5).astype(np.float32)
    gt = np.concatenate([rng.uniform(0.1, 0.9, (n, nb, 2)),
                         rng.uniform(0.05, 0.6, (n, nb, 2))], -1).astype(np.float32)
    gt[0, -2:] = 0.0          # padding rows
    label = rng.randint(0, c, (n, nb)).astype(np.int32)
    label[0, -1] = -1         # padding labels out of range
    label[1, -1] = c + 2
    attrs = {"anchors": ANCHORS, "anchor_mask": mask, "class_num": c,
             "ignore_thresh": 0.5, "downsample_ratio": 8}
    check_det("yolov3_loss", attrs, {"X": x, "GTBox": gt, "GTLabel": label},
              {"Loss": 1}, diff=["X"])


def _proposal_inputs(seed, b=2, a=3, h=6, w=7):
    rng = np.random.RandomState(seed)
    scores = rng.randn(b, a, h, w).astype(np.float32)
    scores[0, 0, 0, :3] = scores[0, 1, 2, 3]  # tied scores
    deltas = (rng.randn(b, 4 * a, h, w) * 0.2).astype(np.float32)
    info = np.array([[96.0, 112.0, 1.0], [80.0, 100.0, 1.5]], np.float32)
    return scores, deltas, info


def _anchors(h=6, w=7):
    out = run_jax("anchor_generator",
                  {"anchor_sizes": [16.0, 32.0, 64.0], "aspect_ratios": [1.0],
                   "stride": [16.0, 16.0], "variances": [1.0, 1.0, 1.0, 1.0]},
                  {"Input": np.zeros((1, 1, h, w), np.float32)},
                  {"Anchors": 1, "Variances": 1})
    return out["Anchors"], out["Variances"]


def test_generate_proposals():
    scores, deltas, info = _proposal_inputs(5)
    anchors, var = _anchors()
    attrs = {"pre_nms_topN": 60, "post_nms_topN": 20, "nms_thresh": 0.5,
             "min_size": 2.0}
    got = check_det("generate_proposals", attrs,
                    {"Scores": scores, "BboxDeltas": deltas, "ImInfo": info,
                     "Anchors": anchors, "Variances": var},
                    {"RpnRois": 1, "RpnRoiProbs": 1, "Length": 1}, diff=[])
    assert (got["Length"] > 0).all()
    # post > pre: padded with -1
    check_det("generate_proposals", dict(attrs, pre_nms_topN=15, post_nms_topN=25),
              {"Scores": scores, "BboxDeltas": deltas, "ImInfo": info,
               "Anchors": anchors, "Variances": var},
              {"RpnRois": 1, "RpnRoiProbs": 1, "Length": 1}, diff=[])


def _rpn_inputs(seed):
    rng = np.random.RandomState(seed)
    anchors = _anchors()[0].reshape(-1, 4)
    gt = boxes(rng, 4, (2,), hi=90.0, min_wh=0.2)
    gt[1, -1] = 0.0
    info = np.array([[96.0, 112.0, 1.0], [90.0, 100.0, 1.0]], np.float32)
    return {"Anchor": anchors, "GtBoxes": gt, "ImInfo": info}


RPN_OUTS = {"ScoreMask": 1, "TargetLabel": 1, "TargetBBox": 1,
            "BBoxInsideWeight": 1}
RPN_ATTRS = {"rpn_batch_size_per_im": 32, "rpn_straddle_thresh": 0.0,
             "rpn_fg_fraction": 0.25, "rpn_positive_overlap": 0.5,
             "rpn_negative_overlap": 0.3}


def test_rpn_target_assign_equal_without_random():
    got = check_det("rpn_target_assign", dict(RPN_ATTRS, use_random=False),
                    _rpn_inputs(6), RPN_OUTS, diff=[])
    assert (got["ScoreMask"] == 1).any() and (got["ScoreMask"] == 0).any()
    check_det("rpn_target_assign",
              dict(RPN_ATTRS, use_random=False, rpn_straddle_thresh=-1.0),
              _rpn_inputs(7), RPN_OUTS, diff=[])


def test_rpn_target_assign_random_keeps_the_invariants():
    inputs = _rpn_inputs(8)
    fixed = check_det("rpn_target_assign", dict(RPN_ATTRS, use_random=False),
                      inputs, RPN_OUTS, diff=[])
    _, got = run_port("rpn_target_assign", dict(RPN_ATTRS, use_random=True),
                      inputs, RPN_OUTS, seed=3)
    _, again = run_port("rpn_target_assign", dict(RPN_ATTRS, use_random=True),
                        inputs, RPN_OUTS, seed=3)
    assert torch.equal(got["ScoreMask"], again["ScoreMask"])
    fg, bg = got["ScoreMask"] == 1, got["ScoreMask"] == 0
    fg0, bg0 = fixed["ScoreMask"] == 1, fixed["ScoreMask"] == 0
    # the same counts as the first-k sample (the eligible sets are the
    # same); fg at most 25 % of the batch, fg + bg the batch
    assert torch.equal(fg.sum(1), fg0.sum(1))
    assert (fg.sum(1) <= 8).all() and ((fg | bg).sum(1) == 32).all()
    # only eligible anchors are drawn: an fg sample is fg-eligible
    want = check_det("rpn_target_assign",
                     dict(RPN_ATTRS, use_random=False,
                          rpn_batch_size_per_im=100000, rpn_fg_fraction=1.0),
                     inputs, RPN_OUTS, diff=[])
    assert not (fg & (want["ScoreMask"] != 1)).any()
    assert torch.equal(got["TargetLabel"].bool(), fg)


LABEL_OUTS = {"Rois": 1, "LabelsInt32": 1, "BboxTargets": 1,
              "BboxInsideWeights": 1, "BboxOutsideWeights": 1, "RoiWeights": 1}


def _label_inputs(seed, b=2, r=30, ng=4):
    rng = np.random.RandomState(seed)
    gt = boxes(rng, ng, (b,), hi=60.0, min_wh=0.15)
    gt[0, -1] = 0.0
    rois = np.concatenate([gt + rng.randn(b, ng, 4).astype(np.float32) * 2,
                           boxes(rng, r - ng, (b,), hi=60.0, min_wh=0.1)], 1)
    rois[1, -3:] = -1.0  # padded proposals
    return {"RpnRois": rois.astype(np.float32),
            "GtClasses": rng.randint(1, 5, (b, ng)).astype(np.int32),
            "GtBoxes": gt,
            "ImInfo": np.array([[64.0, 64.0, 1.0]] * b, np.float32)}


LABEL_ATTRS = {"batch_size_per_im": 16, "fg_fraction": 0.25, "fg_thresh": 0.5,
               "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0, "class_nums": 5,
               "bbox_reg_weights": [0.1, 0.1, 0.2, 0.2]}


def test_generate_proposal_labels_equal_without_random():
    got = check_det("generate_proposal_labels",
                    dict(LABEL_ATTRS, use_random=False), _label_inputs(9),
                    LABEL_OUTS, diff=[])
    assert (got["LabelsInt32"] > 0).any()


def test_generate_proposal_labels_random_keeps_the_invariants():
    inputs = _label_inputs(10)
    fixed = check_det("generate_proposal_labels",
                      dict(LABEL_ATTRS, use_random=False), inputs,
                      LABEL_OUTS, diff=[])
    _, got = run_port("generate_proposal_labels", dict(LABEL_ATTRS, use_random=True),
                      inputs, LABEL_OUTS, seed=4)
    lab, lab0 = got["LabelsInt32"], fixed["LabelsInt32"]
    assert torch.equal((lab > 0).sum(1), (lab0 > 0).sum(1))
    assert torch.equal((lab >= 0).sum(1), (lab0 >= 0).sum(1))
    assert ((lab > 0).sum(1) <= 4).all()
    assert torch.equal(got["RoiWeights"] > 0, lab >= 0)
    # every sampled fg row's label is a gt class, its targets in its block
    iw = got["BboxInsideWeights"].reshape(2, 16, 5, 4)
    assert torch.equal(iw.sum((2, 3)) > 0, lab > 0)


def _mask_inputs(seed, b=2, s=6, ng=3, l=6):
    rng = np.random.RandomState(seed)
    ctr = rng.uniform(8, 24, (b, ng, 1, 2))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (b, ng, l)), -1)
    rad = rng.uniform(3, 8, (b, ng, l))
    segms = (ctr + np.stack([np.cos(ang), np.sin(ang)], -1) * rad[..., None])
    plen = rng.randint(3, l + 1, (b, ng)).astype(np.int32)
    plen[1, -1] = 2  # not a polygon
    rois = boxes(rng, s, (b,), hi=32.0, min_wh=0.2)
    labels = rng.randint(-1, 4, (b, s)).astype(np.int32)
    return {"Rois": rois, "LabelsInt32": labels,
            "GtSegms": segms.astype(np.float32), "GtPolyLength": plen,
            "GtClasses": rng.randint(1, 4, (b, ng)).astype(np.int32),
            "ImInfo": np.array([[32.0, 32.0, 1.0]] * b, np.float32)}


def test_generate_mask_labels():
    got = check_det("generate_mask_labels", {"num_classes": 4, "resolution": 7},
                    _mask_inputs(11), {"MaskInt32": 1, "RoiHasMaskInt32": 1},
                    diff=[])
    assert (got["MaskInt32"] == 1).any()
    inputs = _mask_inputs(12)
    del inputs["GtPolyLength"]
    check_det("generate_mask_labels", {"num_classes": 4, "resolution": 5},
              inputs, {"MaskInt32": 1, "RoiHasMaskInt32": 1}, diff=[])


def _map_inputs(seed, b=3, k=8, ng=4, c=4):
    rng = np.random.RandomState(seed)
    gt_b = boxes(rng, ng, (b,), min_wh=0.1)
    gt = np.concatenate([rng.randint(0, c, (b, ng, 1)), gt_b], -1)
    gt[0, -1, 1:] = 0.0
    det_b = np.concatenate([gt_b + rng.randn(b, ng, 4) * 0.02,
                            boxes(rng, k - ng, (b,))], 1)
    det = np.concatenate([rng.randint(0, c, (b, k, 1)),
                          rng.randint(1, 9, (b, k, 1)) / 9.0, det_b], -1)
    det[:, :ng, 0] = gt[:, :, 0]
    length = rng.randint(k - 3, k + 1, (b,)).astype(np.int32)
    return det.astype(np.float32), gt.astype(np.float32), length


@pytest.mark.parametrize("ap", ("integral", "11point"))
def test_detection_map_matches(ap):
    det, gt, length = _map_inputs(13)
    attrs = {"overlap_threshold": 0.5, "ap_type": ap, "evaluate_difficult": True,
             "background_label": 0}
    got = check_det("detection_map", attrs,
                    {"DetectRes": det, "Label": gt, "DetLength": length},
                    {"MAP": 1}, diff=[])
    assert 0.0 < float(got["MAP"]) <= 1.0
    check_det("detection_map", dict(attrs, background_label=-1),
              {"DetectRes": det, "Label": gt}, {"MAP": 1}, diff=[])
    with pytest.raises(NotImplementedError):
        run_port("detection_map", dict(attrs, evaluate_difficult=False),
                 {"DetectRes": det, "Label": gt}, {"MAP": 1})


def test_detection_map_metric_equals_the_jax_package():
    j, t = jmetrics.DetectionMAP(), tmetrics.DetectionMAP()
    for seed in (14, 15):
        det, gt, length = _map_inputs(seed)
        j.update(det, length, gt)
        t.update(det, length, gt)
    assert t.eval() == j.eval()
    j11 = jmetrics.DetectionMAP(ap_version="11point")
    t11 = tmetrics.DetectionMAP(ap_version="11point")
    det, gt, length = _map_inputs(16)
    j11.update(det, length, gt)
    t11.update(det, length, gt)
    assert t11.eval() == j11.eval()
