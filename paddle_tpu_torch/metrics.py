# ported from paddle_tpu/metrics.py
"""Python-side metric accumulators (reference: python/paddle/fluid/metrics.py).

They accumulate on the host in numpy, as the JAX package's do; an update
takes numpy arrays, Python numbers or tensors (a tensor on the card is
copied to the host)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MetricBase", "Accuracy", "Precision", "Recall", "Auc",
           "EditDistance", "CompositeMetric", "ChunkEvaluator",
           "DetectionMAP"]


def _np(x):
    """``x`` as a numpy array: a tensor is detached and copied to the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _num(x):
    """A Python number of a scalar tensor, else ``x`` unchanged."""
    return x.item() if isinstance(x, torch.Tensor) else x


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for k, v in self.__dict__.items():
            if k.startswith("_"):
                continue
            if isinstance(v, (int, float)):
                setattr(self, k, 0)
            elif isinstance(v, np.ndarray):
                setattr(self, k, np.zeros_like(v))

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        value, weight = _num(value), _num(weight)
        self.value += float(value) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("Accuracy: no updates yet")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(_np(preds)).astype(int).reshape(-1)
        labels = _np(labels).astype(int).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(_np(preds)).astype(int).reshape(-1)
        labels = _np(labels).astype(int).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(MetricBase):
    """Histogram AUC accumulator matching the in-graph auc op."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num = num_thresholds + 1
        self.stat_pos = np.zeros(self._num, dtype=np.float64)
        self.stat_neg = np.zeros(self._num, dtype=np.float64)

    def update(self, preds, labels):
        preds = _np(preds)
        pos_prob = preds[:, 1] if preds.ndim == 2 and preds.shape[1] == 2 else preds.reshape(-1)
        labels = _np(labels).reshape(-1)
        bucket = np.clip((pos_prob * self._num).astype(int), 0, self._num - 1)
        for b, l in zip(bucket, labels):
            if l > 0:
                self.stat_pos[b] += 1
            else:
                self.stat_neg[b] += 1

    def eval(self):
        tot_pos = self.stat_pos.sum()
        tot_neg = self.stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        pos_above = tot_pos - np.cumsum(self.stat_pos)
        auc_sum = np.sum(self.stat_neg * (pos_above + self.stat_pos * 0.5))
        return float(auc_sum / (tot_pos * tot_neg))


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num=None):
        distances = _np(distances).reshape(-1)
        self.total_distance += float(distances.sum())
        self.seq_num += _num(seq_num) if seq_num is not None else len(distances)
        self.instance_error += int(np.sum(distances > 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("EditDistance: no updates yet")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class DetectionMAP(MetricBase):
    """Mean average precision over padded detection outputs (reference:
    python/paddle/fluid/metrics.py DetectionMAP + detection_map_op.cc).

    ``update(det, det_len, gt)``:
    - det: [B, K, 6] rows (label, score, x1, y1, x2, y2), -1-padded
      (multiclass_nms output convention)
    - det_len: [B] valid counts (the Length output)
    - gt: [B, Ng, 5] rows (label, x1, y1, x2, y2); zero-area rows pad

    ``eval()`` → mAP with ``ap_version`` 'integral' or '11point'.
    """

    def __init__(self, name=None, overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version="integral"):
        super().__init__(name)
        if ap_version not in ("integral", "11point"):
            raise ValueError("ap_version must be 'integral' or '11point'")
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self.reset()

    def reset(self, executor=None, reset_program=None):
        self._gt_count = {}        # class -> total gt
        self._records = {}         # class -> list of (score, tp)

    @staticmethod
    def _iou(a, b):
        ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
        iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = ix * iy
        ua = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
              - inter)
        return inter / ua if ua > 0 else 0.0

    def update(self, det, det_len, gt):
        det = _np(det)
        det_len = _np(det_len).astype(int)
        gt = _np(gt)
        for b in range(det.shape[0]):
            gts = [g for g in gt[b] if g[3] > g[1] and g[4] > g[2]]
            for g in gts:
                c = int(g[0])
                self._gt_count[c] = self._gt_count.get(c, 0) + 1
            used = [False] * len(gts)
            rows = det[b, :det_len[b]]
            for lab, score, *box in sorted(rows.tolist(), key=lambda r: -r[1]):
                c = int(lab)
                best, best_j = 0.0, -1
                for j, g in enumerate(gts):
                    if int(g[0]) != c or used[j]:
                        continue
                    ov = self._iou(box, g[1:5])
                    if ov > best:
                        best, best_j = ov, j
                tp = best >= self.overlap_threshold and best_j >= 0
                if tp:
                    used[best_j] = True
                self._records.setdefault(c, []).append((float(score), bool(tp)))

    def eval(self, executor=None):
        aps = []
        for c, total in self._gt_count.items():
            recs = sorted(self._records.get(c, []), key=lambda r: -r[0])
            if total == 0:
                continue
            tp_cum = fp_cum = 0
            precisions, recalls = [], []
            for _, tp in recs:
                tp_cum += tp
                fp_cum += not tp
                precisions.append(tp_cum / (tp_cum + fp_cum))
                recalls.append(tp_cum / total)
            if not recs:
                aps.append(0.0)
                continue
            if self.ap_version == "integral":
                ap, prev_r = 0.0, 0.0
                for p, r in zip(precisions, recalls):
                    ap += p * (r - prev_r)
                    prev_r = r
            else:  # 11point
                ap = 0.0
                for t in np.linspace(0, 1, 11):
                    ps = [p for p, r in zip(precisions, recalls) if r >= t]
                    ap += (max(ps) if ps else 0.0) / 11.0
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0


class ChunkEvaluator(MetricBase):
    """Accumulate chunk_eval op counters across mini-batches and derive
    precision/recall/F1 (reference: python/paddle/fluid/metrics.py:359)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self, executor=None, reset_program=None):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(_np(num_infer_chunks).sum())
        self.num_label_chunks += int(_np(num_label_chunks).sum())
        self.num_correct_chunks += int(_np(num_correct_chunks).sum())

    def eval(self, executor=None):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1
