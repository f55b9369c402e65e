# ported from paddle_tpu/layers/detection.py
"""Detection layer builders (reference: python/paddle/fluid/layers/detection.py
— 2.2k LoC: prior_box:1109, box_coder:345, multiclass_nms:2108,
detection_output:204, ssd_loss:875, multi_box_head:1355, yolov3_loss:508,
bipartite_match:703, target_assign:789, anchor_generator:1601,
generate_proposals:1973, box_clip:2060, iou_similarity:317).

Dense-batch conventions (see ops/detection_ops.py): ground-truth inputs are
[B, Ng, ...] with zero-area padding rows instead of LoD; variable-size
outputs are padded + Length. Every op these layers append runs on the
card without a host read, but ``detection_map``, a host op.
"""

from __future__ import annotations

from .layer_helper import LayerHelper
from . import nn as nn_layers
from . import tensor as tensor_layers

__all__ = [
    "iou_similarity", "box_coder", "prior_box", "density_prior_box",
    "anchor_generator", "box_clip", "bipartite_match", "target_assign",
    "multiclass_nms", "detection_output", "ssd_loss", "multi_box_head",
    "roi_align", "roi_pool", "yolov3_loss", "generate_proposals",
    "polygon_box_transform", "mine_hard_examples",
]


def iou_similarity(x, y, box_normalized=True, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("iou_similarity", inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"box_normalized": box_normalized})
    return out


def box_coder(prior_box, prior_box_var, target_box, code_type="encode_center_size",
              box_normalized=True, name=None, axis=0):
    helper = LayerHelper("box_coder", name=name)
    out = helper.create_variable_for_type_inference(prior_box.dtype)
    inputs = {"PriorBox": prior_box, "TargetBox": target_box}
    attrs = {"code_type": code_type, "box_normalized": box_normalized, "axis": axis}
    if isinstance(prior_box_var, (list, tuple)):
        attrs["variance"] = [float(v) for v in prior_box_var]
    elif prior_box_var is not None:
        inputs["PriorBoxVar"] = prior_box_var
    helper.append_op("box_coder", inputs=inputs, outputs={"OutputBox": out}, attrs=attrs)
    return out


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    helper = LayerHelper("prior_box", name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "prior_box", inputs={"Input": input, "Image": image},
        outputs={"Boxes": boxes, "Variances": var},
        attrs={
            "min_sizes": [float(s) for s in (min_sizes if isinstance(min_sizes, (list, tuple)) else [min_sizes])],
            "max_sizes": [float(s) for s in (max_sizes or [])] if not isinstance(max_sizes, (int, float)) else [float(max_sizes)],
            "aspect_ratios": [float(a) for a in aspect_ratios],
            "variances": [float(v) for v in variance],
            "flip": flip, "clip": clip,
            "step_w": float(steps[0]), "step_h": float(steps[1]),
            "offset": float(offset),
            "min_max_aspect_ratios_order": min_max_aspect_ratios_order,
        })
    return boxes, var


def density_prior_box(input, image, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=(0.1, 0.1, 0.2, 0.2),
                      clip=False, steps=(0.0, 0.0), offset=0.5,
                      flatten_to_2d=False, name=None):
    helper = LayerHelper("density_prior_box", name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "density_prior_box", inputs={"Input": input, "Image": image},
        outputs={"Boxes": boxes, "Variances": var},
        attrs={
            "densities": [int(d) for d in densities],
            "fixed_sizes": [float(s) for s in fixed_sizes],
            "fixed_ratios": [float(r) for r in fixed_ratios],
            "variances": [float(v) for v in variance],
            "clip": clip, "step_w": float(steps[0]), "step_h": float(steps[1]),
            "offset": float(offset),
        })
    if flatten_to_2d:
        boxes = tensor_layers.reshape(boxes, shape=[-1, 4])
        var = tensor_layers.reshape(var, shape=[-1, 4])
    return boxes, var


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=None, offset=0.5,
                     name=None):
    helper = LayerHelper("anchor_generator", name=name)
    anchors = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "anchor_generator", inputs={"Input": input},
        outputs={"Anchors": anchors, "Variances": var},
        attrs={
            "anchor_sizes": [float(s) for s in anchor_sizes],
            "aspect_ratios": [float(r) for r in aspect_ratios],
            "variances": [float(v) for v in variance],
            "stride": [float(s) for s in stride],
            "offset": float(offset),
        })
    return anchors, var


def box_clip(input, im_info, name=None):
    helper = LayerHelper("box_clip", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("box_clip", inputs={"Input": input, "ImInfo": im_info},
                     outputs={"Output": out})
    return out


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None, name=None):
    helper = LayerHelper("bipartite_match", name=name)
    idx = helper.create_variable_for_type_inference("int32")
    dist = helper.create_variable_for_type_inference(dist_matrix.dtype)
    helper.append_op(
        "bipartite_match", inputs={"DistMat": dist_matrix},
        outputs={"ColToRowMatchIndices": idx, "ColToRowMatchDist": dist},
        attrs={"match_type": match_type or "bipartite",
               "dist_threshold": float(dist_threshold or 0.5)})
    return idx, dist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    """``negative_indices`` takes the NegMask [B, M] produced by
    mine_hard_examples (static-shape stand-in for the reference's LoD)."""
    helper = LayerHelper("target_assign", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_weight = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        "target_assign",
        inputs={"X": input, "MatchIndices": matched_indices, "NegMask": negative_indices},
        outputs={"Out": out, "OutWeight": out_weight},
        attrs={"mismatch_value": mismatch_value or 0})
    return out, out_weight


def mine_hard_examples(cls_loss, match_indices, match_dist, neg_pos_ratio=3.0,
                       neg_dist_threshold=0.5, name=None):
    helper = LayerHelper("mine_hard_examples", name=name)
    neg_mask = helper.create_variable_for_type_inference("int32")
    updated = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "mine_hard_examples",
        inputs={"ClsLoss": cls_loss, "MatchIndices": match_indices,
                "MatchDist": match_dist},
        outputs={"NegMask": neg_mask, "UpdatedMatchIndices": updated},
        attrs={"neg_pos_ratio": float(neg_pos_ratio),
               "neg_dist_threshold": float(neg_dist_threshold)})
    return neg_mask, updated


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None, return_length=False):
    """Out [B, keep_top_k, 6] padded with -1 (+ Length [B] when
    ``return_length``) — padded+Length replacing the reference's LoD out."""
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    length = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "multiclass_nms", inputs={"BBoxes": bboxes, "Scores": scores},
        outputs={"Out": out, "Length": length},
        attrs={"background_label": background_label,
               "score_threshold": float(score_threshold),
               "nms_top_k": int(nms_top_k), "nms_threshold": float(nms_threshold),
               "nms_eta": float(nms_eta), "keep_top_k": int(keep_top_k),
               "normalized": normalized})
    return (out, length) if return_length else out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     return_length=False):
    """SSD inference head (reference: detection.py:204): decode loc against
    priors, then class-wise NMS. loc [B, P, 4], scores [B, P, C] (softmax'd
    here), priors [P, 4]."""
    # loc [B, P, 4]: priors vary along dim 1 → axis=0 (reference
    # DecodeCenterSize indexes priors by the second target dim when axis==0)
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size", axis=0)
    scores = nn_layers.softmax(scores, axis=-1)
    scores_t = tensor_layers.transpose(scores, perm=[0, 2, 1])  # [B, C, P]
    return multiclass_nms(
        decoded, scores_t, score_threshold=score_threshold,
        nms_top_k=nms_top_k, keep_top_k=keep_top_k, nms_threshold=nms_threshold,
        nms_eta=nms_eta, background_label=background_label,
        return_length=return_length)


def ssd_loss(location, confidence, gt_box, gt_label, prior_box, prior_box_var=None,
             background_label=0, overlap_threshold=0.5, neg_pos_ratio=3.0,
             neg_overlap=0.5, loc_loss_weight=1.0, conf_loss_weight=1.0,
             match_type="per_prediction", mining_type="max_negative",
             normalize=True, sample_size=None):
    """SSD multibox loss (reference: detection.py:875 ssd_loss).

    location [B, P, 4], confidence [B, P, C], gt_box [B, Ng, 4] (zero-area
    rows = padding), gt_label [B, Ng, 1] int, prior_box [P, 4]. Returns the
    per-image loss [B, 1]: matching → hard-negative mining → weighted
    loc (smooth-L1) + conf (softmax CE) losses, normalized by matched count.
    """
    if mining_type != "max_negative":
        raise NotImplementedError("only max_negative mining is implemented "
                                  "(the reference's hard_example path is unused upstream)")
    # 1. match priors to gt by IoU
    iou = iou_similarity(gt_box, prior_box)                  # [B, Ng, P]
    matched_index, matched_dist = bipartite_match(iou, match_type, overlap_threshold)

    # 2. conf loss with current confidences (for mining)
    gt_lbl_f = tensor_layers.cast(gt_label, "int64")
    tgt_lbl, _ = target_assign(gt_lbl_f, matched_index,
                               mismatch_value=background_label)  # [B, P, 1]
    conf_loss_all = nn_layers.softmax_with_cross_entropy(
        confidence, tensor_layers.cast(tgt_lbl, "int64"))        # [B, P, 1]
    conf_loss_2d = tensor_layers.reshape(conf_loss_all, shape=[0, -1])

    # 3. mine hard negatives
    neg_mask, _ = mine_hard_examples(conf_loss_2d, matched_index, matched_dist,
                                     neg_pos_ratio=neg_pos_ratio,
                                     neg_dist_threshold=neg_overlap)

    # 4. targets: encoded loc for positives; labels incl. mined negatives
    encoded = box_coder(prior_box, prior_box_var, gt_box)        # [B, Ng, P, 4]
    loc_tgt, loc_w = target_assign(encoded, matched_index)       # [B, P, 4], [B, P, 1]
    conf_tgt, conf_w = target_assign(gt_lbl_f, matched_index,
                                     negative_indices=neg_mask,
                                     mismatch_value=background_label)

    # 5. weighted losses (2D per-prior rows, reference __reshape_to_2d)
    loc_2d = tensor_layers.reshape(location, shape=[-1, 4])
    tgt_2d = tensor_layers.reshape(loc_tgt, shape=[-1, 4])
    loc_loss = nn_layers.smooth_l1(loc_2d, tgt_2d)               # [B*P, 1]
    loc_loss = tensor_layers.reshape(loc_loss, shape=[0, -1])    # keep 2D
    conf_loss = nn_layers.softmax_with_cross_entropy(
        confidence, tensor_layers.cast(conf_tgt, "int64"))
    loc_w2 = tensor_layers.reshape(loc_w, shape=[-1, 1])
    conf_w2 = tensor_layers.reshape(conf_w, shape=[-1, 1])
    conf_2d = tensor_layers.reshape(conf_loss, shape=[-1, 1])

    b_rows = tensor_layers.reshape(
        nn_layers.elementwise_add(
            tensor_layers.scale(nn_layers.elementwise_mul(loc_loss, loc_w2),
                                scale=loc_loss_weight),
            tensor_layers.scale(nn_layers.elementwise_mul(conf_2d, conf_w2),
                                scale=conf_loss_weight)),
        shape=[-1, int(location.shape[1])])
    loss = nn_layers.reduce_sum(b_rows, dim=1, keep_dim=True)    # [B, 1]
    if normalize:
        denom = nn_layers.reduce_sum(
            tensor_layers.reshape(loc_w, shape=[0, -1]), dim=1, keep_dim=True)
        denom = nn_layers.clip(denom, min=1.0, max=1e30)
        loss = nn_layers.elementwise_div(loss, denom)
    return loss


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None, max_sizes=None,
                   steps=None, step_w=None, step_h=None, offset=0.5,
                   variance=(0.1, 0.1, 0.2, 0.2), flip=True, clip=False,
                   kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD head over multiple feature maps (reference: detection.py:1355):
    per-level conv predictions for loc/conf + priors, concatenated."""
    n_layer = len(inputs)
    if min_sizes is None:
        # evenly spaced ratios between min_ratio and max_ratio (reference alg)
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (n_layer - 2)) if n_layer > 2 else 0
        for ratio in range(min_ratio, max_ratio + 1, max(step, 1)):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes[:n_layer - 1]
        max_sizes = [base_size * 0.2] + max_sizes[:n_layer - 1]

    locs, confs, boxes_l, vars_l = [], [], [], []
    for i, feat in enumerate(inputs):
        mins = min_sizes[i] if isinstance(min_sizes[i], (list, tuple)) else [min_sizes[i]]
        maxs = (max_sizes[i] if isinstance(max_sizes[i], (list, tuple)) else [max_sizes[i]]) if max_sizes else []
        ars = aspect_ratios[i] if isinstance(aspect_ratios[i], (list, tuple)) else [aspect_ratios[i]]
        step_pair = (steps[i] if steps else (step_w[i] if step_w else 0.0,
                                             step_h[i] if step_h else 0.0))
        if not isinstance(step_pair, (list, tuple)):
            step_pair = (step_pair, step_pair)
        box, var = prior_box(feat, image, mins, maxs, ars, variance, flip, clip,
                             step_pair, offset,
                             min_max_aspect_ratios_order=min_max_aspect_ratios_order)
        boxes_l.append(tensor_layers.reshape(box, shape=[-1, 4]))
        vars_l.append(tensor_layers.reshape(var, shape=[-1, 4]))
        # count must mirror the op: 1 (min) + extra ARs + (1 if max)
        ar_n = 1
        seen = [1.0]
        for r in ars:
            r = float(r)
            if all(abs(r - s) > 1e-6 for s in seen):
                seen.append(r)
                ar_n += 1
                if flip:
                    seen.append(1.0 / r)
                    ar_n += 1
        num_priors = ar_n * len(mins) + (len(maxs) if maxs else 0)

        loc = nn_layers.conv2d(feat, num_filters=num_priors * 4,
                               filter_size=kernel_size, padding=pad, stride=stride)
        loc = tensor_layers.transpose(loc, perm=[0, 2, 3, 1])
        locs.append(tensor_layers.reshape(loc, shape=[0, -1, 4]))
        conf = nn_layers.conv2d(feat, num_filters=num_priors * num_classes,
                                filter_size=kernel_size, padding=pad, stride=stride)
        conf = tensor_layers.transpose(conf, perm=[0, 2, 3, 1])
        confs.append(tensor_layers.reshape(conf, shape=[0, -1, num_classes]))

    mbox_locs = tensor_layers.concat(locs, axis=1)
    mbox_confs = tensor_layers.concat(confs, axis=1)
    boxes = tensor_layers.concat(boxes_l, axis=0)
    vars_ = tensor_layers.concat(vars_l, axis=0)
    return mbox_locs, mbox_confs, boxes, vars_


def roi_align(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
              sampling_ratio=-1, batch_id=None, name=None):
    helper = LayerHelper("roi_align", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "roi_align", inputs={"X": input, "ROIs": rois, "BatchId": batch_id},
        outputs={"Out": out},
        attrs={"pooled_height": pooled_height, "pooled_width": pooled_width,
               "spatial_scale": float(spatial_scale),
               "sampling_ratio": sampling_ratio})
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
             batch_id=None, name=None):
    helper = LayerHelper("roi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "roi_pool", inputs={"X": input, "ROIs": rois, "BatchId": batch_id},
        outputs={"Out": out},
        attrs={"pooled_height": pooled_height, "pooled_width": pooled_width,
               "spatial_scale": float(spatial_scale)})
    return out


def yolov3_loss(x, gtbox, gtlabel, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, name=None):
    helper = LayerHelper("yolov3_loss", name=name)
    loss = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "yolov3_loss", inputs={"X": x, "GTBox": gtbox, "GTLabel": gtlabel},
        outputs={"Loss": loss},
        attrs={"anchors": [int(a) for a in anchors],
               "anchor_mask": [int(m) for m in anchor_mask],
               "class_num": int(class_num),
               "ignore_thresh": float(ignore_thresh),
               "downsample_ratio": int(downsample_ratio)})
    return loss


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000, nms_thresh=0.5,
                       min_size=0.1, eta=1.0, name=None, return_length=False):
    helper = LayerHelper("generate_proposals", name=name)
    rois = helper.create_variable_for_type_inference(scores.dtype)
    probs = helper.create_variable_for_type_inference(scores.dtype)
    length = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "generate_proposals",
        inputs={"Scores": scores, "BboxDeltas": bbox_deltas, "ImInfo": im_info,
                "Anchors": anchors, "Variances": variances},
        outputs={"RpnRois": rois, "RpnRoiProbs": probs, "Length": length},
        attrs={"pre_nms_topN": int(pre_nms_top_n), "post_nms_topN": int(post_nms_top_n),
               "nms_thresh": float(nms_thresh), "min_size": float(min_size)})
    if return_length:
        return rois, probs, length
    return rois, probs


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("polygon_box_transform", inputs={"Input": input},
                     outputs={"Output": out})
    return out


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var, gt_boxes,
                      is_crowd=None, im_info=None, rpn_batch_size_per_im=256,
                      rpn_straddle_thresh=0.0, rpn_fg_fraction=0.5,
                      rpn_positive_overlap=0.7, rpn_negative_overlap=0.3,
                      use_random=True):
    """RPN anchor sampling (reference: detection.py:57 → 
    rpn_target_assign_op.cc). Static redesign: returns
    (score_mask [B, A] {-1 ignore, 0 bg, 1 fg}, target_label [B, A],
    target_bbox [B, A, 4], bbox_inside_weight [B, A, 4]) instead of the
    reference's ragged gathered index lists; the losses mask with
    score_mask >= 0 (score) and == 1 (loc)."""
    helper = LayerHelper("rpn_target_assign")
    score_mask = helper.create_variable_for_type_inference("int32")
    tgt_lbl = helper.create_variable_for_type_inference("int32")
    tgt_bbox = helper.create_variable_for_type_inference(gt_boxes.dtype)
    inw = helper.create_variable_for_type_inference(gt_boxes.dtype)
    helper.append_op(
        "rpn_target_assign",
        inputs={"Anchor": anchor_box, "GtBoxes": gt_boxes, "IsCrowd": is_crowd,
                "ImInfo": im_info},
        outputs={"ScoreMask": score_mask, "TargetLabel": tgt_lbl,
                 "TargetBBox": tgt_bbox, "BBoxInsideWeight": inw},
        attrs={"rpn_batch_size_per_im": rpn_batch_size_per_im,
               "rpn_straddle_thresh": rpn_straddle_thresh,
               "rpn_fg_fraction": rpn_fg_fraction,
               "rpn_positive_overlap": rpn_positive_overlap,
               "rpn_negative_overlap": rpn_negative_overlap,
               "use_random": use_random})
    return score_mask, tgt_lbl, tgt_bbox, inw


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes, im_info,
                             batch_size_per_im=256, fg_fraction=0.25,
                             fg_thresh=0.25, bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True):
    """Second-stage RoI sampling (reference: detection.py:1744)."""
    helper = LayerHelper("generate_proposal_labels")
    rois = helper.create_variable_for_type_inference(rpn_rois.dtype)
    labels = helper.create_variable_for_type_inference("int32")
    tgts = helper.create_variable_for_type_inference(rpn_rois.dtype)
    iw = helper.create_variable_for_type_inference(rpn_rois.dtype)
    ow = helper.create_variable_for_type_inference(rpn_rois.dtype)
    roiw = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        "generate_proposal_labels",
        inputs={"RpnRois": rpn_rois, "GtClasses": gt_classes,
                "IsCrowd": is_crowd, "GtBoxes": gt_boxes, "ImInfo": im_info},
        outputs={"Rois": rois, "LabelsInt32": labels, "BboxTargets": tgts,
                 "BboxInsideWeights": iw, "BboxOutsideWeights": ow,
                 "RoiWeights": roiw},
        attrs={"batch_size_per_im": batch_size_per_im, "fg_fraction": fg_fraction,
               "fg_thresh": fg_thresh, "bg_thresh_hi": bg_thresh_hi,
               "bg_thresh_lo": bg_thresh_lo,
               "bbox_reg_weights": list(bbox_reg_weights),
               "class_nums": int(class_nums), "use_random": use_random})
    return rois, labels, tgts, iw, ow, roiw


__all__ += ["rpn_target_assign", "generate_proposal_labels"]


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              batch_id=None):
    """Perspective-warp quad RoIs (reference: detection.py
    roi_perspective_transform → roi_perspective_transform_op.cc). rois:
    [R, 8] quad corners; batch_id [R] replaces the reference's RoI LoD."""
    helper = LayerHelper("roi_perspective_transform")
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input, "ROIs": rois}
    if batch_id is not None:
        inputs["BatchId"] = batch_id
    helper.append_op(
        "roi_perspective_transform", inputs=inputs, outputs={"Out": out},
        attrs={"transformed_height": int(transformed_height),
               "transformed_width": int(transformed_width),
               "spatial_scale": float(spatial_scale)})
    return out


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution,
                         gt_poly_length=None):
    """Mask R-CNN mask targets (reference: detection.py generate_mask_labels
    → generate_mask_labels_op.cc). gt_segms: [B, Ng, L, 2] padded polygons
    (+ gt_poly_length [B, Ng]) replace the 3-level LoD."""
    helper = LayerHelper("generate_mask_labels")
    mask = helper.create_variable_for_type_inference("int32")
    has = helper.create_variable_for_type_inference("int32")
    inputs = {"ImInfo": im_info, "GtClasses": gt_classes, "IsCrowd": is_crowd,
              "GtSegms": gt_segms, "Rois": rois, "LabelsInt32": labels_int32}
    if gt_poly_length is not None:
        inputs["GtPolyLength"] = gt_poly_length
    helper.append_op(
        "generate_mask_labels", inputs=inputs,
        outputs={"MaskInt32": mask, "RoiHasMaskInt32": has},
        attrs={"num_classes": int(num_classes), "resolution": int(resolution)})
    return mask, has


def detection_map(detect_res, label, class_num=None, background_label=0,
                  overlap_threshold=0.5, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="integral", det_length=None):
    """Per-batch mAP (reference: detection.py detection_map →
    detection_map_op.cc). Padded convention: detect_res [B, K, 6]
    (+ det_length [B]), label [B, Ng, 5]. Cross-batch accumulation lives in
    metrics.DetectionMAP; the reference's streaming state inputs are not
    supported here."""
    if input_states is not None or out_states is not None or has_state is not None:
        raise NotImplementedError(
            "detection_map: streaming accumulator states are handled by "
            "paddle_tpu_torch.metrics.DetectionMAP; per-batch mAP only here")
    helper = LayerHelper("detection_map")
    out = helper.create_variable_for_type_inference("float32")
    inputs = {"DetectRes": detect_res, "Label": label}
    if det_length is not None:
        inputs["DetLength"] = det_length
    helper.append_op(
        "detection_map", inputs=inputs, outputs={"MAP": out},
        attrs={"overlap_threshold": float(overlap_threshold),
               "ap_type": ap_version,
               "evaluate_difficult": bool(evaluate_difficult),
               "background_label": int(background_label)})
    return out


__all__ += ["roi_perspective_transform", "generate_mask_labels",
            "detection_map"]
