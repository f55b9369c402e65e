"""``fluid.metrics`` (and ``fluid.evaluator``) on the port against the JAX
package's, on seeded inputs: equal results (integer counts exactly, float
accumulations to 1e-12), with the port's updates given numpy arrays or
CPU tensors alike."""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid


def inputs(seed=0, n=64):
    rng = np.random.RandomState(seed)
    probs = rng.rand(n, 2).astype("float32")
    probs /= probs.sum(1, keepdims=True)
    return {"probs": probs, "preds": rng.rand(n).astype("float32"),
            "labels": rng.randint(0, 2, (n, 1)).astype("int64"),
            "acc": float(rng.rand()), "dist": rng.randint(0, 3, n)
            .astype("float32")}


def updates(name, m, x, as_tensor):
    t = (lambda a: torch.as_tensor(a)) if as_tensor else (lambda a: a)
    if name == "Accuracy":
        m.update(t(np.float32(x["acc"])), 64)
    elif name in ("Precision", "Recall"):
        m.update(t(x["preds"]), t(x["labels"]))
    elif name == "Auc":
        m.update(t(x["probs"]), t(x["labels"]))
    elif name == "Auc1d":
        m.update(t(x["preds"]), t(x["labels"]))
    elif name == "EditDistance":
        m.update(t(x["dist"]), 64)
    elif name == "ChunkEvaluator":
        m.update(t(np.int64(int(x["dist"].sum()) + 5)),
                 t(np.int64(int(x["dist"].sum()) + 3)),
                 t(np.int64(int(x["dist"].sum()))))


def make(mod, name):
    if name == "Auc1d":
        return mod.metrics.Auc(num_thresholds=255)
    return getattr(mod.metrics, name)()


def close(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
    return abs(a - b) <= 1e-12 * max(1.0, abs(b))


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("name", ["Accuracy", "Precision", "Recall", "Auc",
                                  "Auc1d", "EditDistance",
                                  "ChunkEvaluator"])
def test_metric_matches_jax(name, as_tensor):
    jm, tm = make(jfluid, name), make(tfluid, name)
    for seed in range(5):
        x = inputs(seed)
        updates(name, jm, x, False)
        updates(name, tm, x, as_tensor)
    got, want = tm.eval(), jm.eval()
    assert close(got, want), (got, want)
    tm.reset()
    jm.reset()
    if name in ("Accuracy", "EditDistance"):
        with pytest.raises(ValueError, match="no updates"):
            tm.eval()
    else:
        assert close(tm.eval(), jm.eval())


def test_composite_metric_matches_jax():
    def comp(mod):
        c = mod.metrics.CompositeMetric()
        c.add_metric(mod.metrics.Precision())
        c.add_metric(mod.metrics.Recall())
        return c

    jc, tc = comp(jfluid), comp(tfluid)
    for seed in range(3):
        x = inputs(seed)
        jc.update(x["preds"], x["labels"])
        tc.update(torch.as_tensor(x["preds"]), x["labels"])
    assert tc.eval() == jc.eval()


def detections(seed):
    rng = np.random.RandomState(seed)
    b, k, g = 3, 6, 4
    det = -np.ones((b, k, 6), "float32")
    gt = np.zeros((b, g, 5), "float32")
    lens = np.zeros(b, "int64")
    for i in range(b):
        n = rng.randint(1, k + 1)
        lens[i] = n
        for j in range(n):
            x1, y1 = rng.rand(2) * 0.5
            det[i, j] = [rng.randint(0, 3), rng.rand(), x1, y1,
                         x1 + 0.2 + 0.3 * rng.rand(), y1 + 0.2 + 0.3 * rng.rand()]
        for j in range(rng.randint(1, g + 1)):
            x1, y1 = rng.rand(2) * 0.5
            gt[i, j] = [rng.randint(0, 3), x1, y1, x1 + 0.3, y1 + 0.3]
    return det, lens, gt


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
def test_detection_map_matches_jax(ap_version):
    jm = jfluid.metrics.DetectionMAP(overlap_threshold=0.3,
                                     ap_version=ap_version)
    tm = tfluid.metrics.DetectionMAP(overlap_threshold=0.3,
                                     ap_version=ap_version)
    for seed in range(4):
        det, lens, gt = detections(seed)
        jm.update(det, lens, gt)
        tm.update(torch.as_tensor(det), lens, torch.as_tensor(gt))
    assert close(tm.eval(), jm.eval()) and 0 < tm.eval() <= 1
    with pytest.raises(ValueError, match="ap_version"):
        tfluid.metrics.DetectionMAP(ap_version="bad")


def test_evaluator_names_resolve_to_metrics():
    assert tfluid.evaluator.ChunkEvaluator is tfluid.metrics.ChunkEvaluator
    assert tfluid.evaluator.EditDistance is tfluid.metrics.EditDistance
    assert tfluid.evaluator.DetectionMAP is tfluid.metrics.DetectionMAP
    assert sorted(tfluid.metrics.__all__) == sorted(jfluid.metrics.__all__)
