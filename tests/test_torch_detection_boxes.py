"""The port's box utilities and prior generators match the JAX package's:
``iou_similarity``, ``box_coder`` (both code types, ``axis`` 0 and 1, the
variance as an attr, a tensor or none), ``prior_box`` (both orders of
``min_max_aspect_ratios_order``), ``density_prior_box``,
``anchor_generator``, ``box_clip`` and ``polygon_box_transform``, outputs
to 1e-5 and gradients to 1e-5 on seeded inputs."""

import numpy as np
import pytest
import torch

from torch_detection_util import boxes, check_det


@pytest.mark.parametrize("normalized", (True, False))
def test_iou_similarity_plain_and_batched(normalized):
    rng = np.random.RandomState(0)
    hi = 1.0 if normalized else 30.0
    x, y = boxes(rng, 5, hi=hi), boxes(rng, 7, hi=hi)
    y[2] = x[1]  # an exact overlap
    check_det("iou_similarity", {"box_normalized": normalized},
              {"X": x, "Y": y}, {"Out": 1})
    xb = boxes(rng, 4, (3,), hi=hi)
    check_det("iou_similarity", {"box_normalized": normalized},
              {"X": xb, "Y": y}, {"Out": 1})
    check_det("iou_similarity", {"box_normalized": normalized},
              {"X": xb, "Y": boxes(rng, 6, (3,), hi=hi)}, {"Out": 1})


VARIANCE = {"tensor": "tensor", "attr": [0.1, 0.1, 0.2, 0.2], "none": None}


@pytest.mark.parametrize("var", sorted(VARIANCE))
@pytest.mark.parametrize("batched", (False, True))
def test_box_coder_encode(var, batched):
    rng = np.random.RandomState(1)
    prior = boxes(rng, 6)
    target = boxes(rng, 4, (2,) if batched else ())
    attrs = {"code_type": "encode_center_size"}
    inputs = {"PriorBox": prior, "TargetBox": target}
    if var == "tensor":
        inputs["PriorBoxVar"] = rng.uniform(0.1, 0.3, (6, 4)).astype(np.float32)
    elif VARIANCE[var]:
        attrs["variance"] = VARIANCE[var]
    check_det("box_coder", attrs, inputs, {"OutputBox": 1})


@pytest.mark.parametrize("var", sorted(VARIANCE))
@pytest.mark.parametrize("axis", (0, 1))
def test_box_coder_decode_both_axes(var, axis):
    rng = np.random.RandomState(2)
    prior = boxes(rng, 5, hi=20.0)
    # axis 0: priors along dim 1 ([N, M, 4]); axis 1: along dim 0
    target = (rng.randn(3, 5, 4) if axis == 0 else rng.randn(5, 3, 4)) * 0.5
    attrs = {"code_type": "decode_center_size", "axis": axis,
             "box_normalized": False}
    inputs = {"PriorBox": prior, "TargetBox": target.astype(np.float32)}
    if var == "tensor":
        inputs["PriorBoxVar"] = rng.uniform(0.1, 0.3, (5, 4)).astype(np.float32)
    elif VARIANCE[var]:
        attrs["variance"] = VARIANCE[var]
    check_det("box_coder", attrs, inputs, {"OutputBox": 1})


def test_box_coder_decode_2d_target():
    rng = np.random.RandomState(3)
    check_det("box_coder", {"code_type": "decode_center_size"},
              {"PriorBox": boxes(rng, 5),
               "TargetBox": (rng.randn(5, 4) * 0.3).astype(np.float32)},
              {"OutputBox": 1})


def _maps(h, w, ih, iw):
    return {"Input": np.zeros((1, 2, h, w), np.float32),
            "Image": np.zeros((1, 3, ih, iw), np.float32)}


@pytest.mark.parametrize("mmorder", (False, True))
@pytest.mark.parametrize("flip,clip", ((True, False), (False, True)))
def test_prior_box_both_orders(mmorder, flip, clip):
    attrs = {"min_sizes": [30.0, 60.0], "max_sizes": [60.0, 111.0],
             "aspect_ratios": [2.0, 3.0], "flip": flip, "clip": clip,
             "variances": [0.1, 0.1, 0.2, 0.2], "offset": 0.5,
             "min_max_aspect_ratios_order": mmorder}
    got = check_det("prior_box", attrs, _maps(5, 4, 40, 32),
                    {"Boxes": 1, "Variances": 1})
    n_ar = 5 if flip else 3
    assert got["Boxes"].shape == (5, 4, 2 * (n_ar + 1), 4)
    check_det("prior_box", dict(attrs, step_w=8.0, step_h=10.0, max_sizes=[]),
              _maps(3, 3, 30, 30), {"Boxes": 1, "Variances": 1})


def test_density_prior_box():
    attrs = {"fixed_sizes": [32.0, 64.0], "fixed_ratios": [1.0, 2.0],
             "densities": [2, 1], "clip": True, "variances": [0.1, 0.1, 0.2, 0.2]}
    got = check_det("density_prior_box", attrs, _maps(4, 5, 64, 80),
                    {"Boxes": 1, "Variances": 1})
    assert got["Boxes"].shape == (4, 5, 2 * 4 + 2, 4)


def test_anchor_generator():
    attrs = {"anchor_sizes": [32.0, 64.0, 128.0], "aspect_ratios": [0.5, 1.0, 2.0],
             "stride": [16.0, 16.0], "variances": [1.0, 1.0, 1.0, 1.0]}
    got = check_det("anchor_generator", attrs,
                    {"Input": np.zeros((1, 4, 3, 5), np.float32)},
                    {"Anchors": 1, "Variances": 1})
    assert got["Anchors"].shape == (3, 5, 9, 4)


def test_box_clip_2d_and_batched():
    rng = np.random.RandomState(4)
    info = np.array([[20.0, 30.0, 1.0], [40.0, 24.0, 2.0]], np.float32)
    b3 = (rng.uniform(-10, 50, (2, 6, 4))).astype(np.float32)
    check_det("box_clip", {}, {"Input": b3, "ImInfo": info}, {"Output": 1})
    check_det("box_clip", {}, {"Input": b3[0], "ImInfo": info[:1]}, {"Output": 1})


def test_polygon_box_transform():
    x = np.random.RandomState(5).randn(2, 8, 3, 4).astype(np.float32)
    check_det("polygon_box_transform", {}, {"Input": x}, {"Output": 1})


def test_prior_box_output_is_kept_per_device():
    """The priors of one op are made once and handed out again: no
    host-to-device copy in a later (captured) step."""
    import types

    from paddle_tpu_torch.core import registry as treg

    op = types.SimpleNamespace(
        type="prior_box", attrs={"min_sizes": [4.0]}, block=None,
        inputs={"Input": ["Input"], "Image": ["Image"]},
        outputs={"Boxes": ["Boxes"], "Variances": ["Variances"]})
    trace = types.SimpleNamespace(is_test=False, program=None,
                                  device=torch.device("cpu"))
    outs = []
    for _ in range(2):
        env = {k: torch.tensor(v) for k, v in _maps(2, 2, 8, 8).items()}
        treg.get_op_impl("prior_box")(treg.OpContext(op, env, trace))
        outs.append(env["Boxes"])
    assert outs[0] is outs[1]
