"""Evaluation metrics (a copy of ``hetu_tpu/metrics.py``, which the
port may not import; reference parity: python/hetu/metrics.py — numpy
confusion-matrix metrics, thresholded confusion series, ROC/PR curves and
Riemann-sum AUC, one-hot precision/recall/F with micro/macro averaging),
plus a streaming thresholded-AUC accumulator for epoch-scale evaluation
without keeping every score in memory."""
from __future__ import annotations

import numpy as np

__all__ = ["accuracy", "precision", "recall", "f1_score", "auc",
           "confusion_matrix", "ConfusionMatrix", "softmax",
           "confusion_matrix_at_thresholds", "roc_pr_curve",
           "auc_at_thresholds", "confusion_matrix_one_hot",
           "precision_score", "recall_score", "f_score", "StreamingAUC"]


def _to_labels(y, axis=-1):
    y = np.asarray(y)
    if y.ndim > 1 and y.shape[axis] > 1:
        return np.argmax(y, axis=axis)
    return y.reshape(-1).astype(np.int64)


def confusion_matrix(y_pred, y_true, num_classes=None):
    p = _to_labels(y_pred)
    t = _to_labels(y_true)
    if num_classes is None:
        num_classes = int(max(p.max(), t.max())) + 1
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (t, p), 1)
    return cm


def accuracy(y_pred, y_true):
    p = _to_labels(y_pred)
    t = _to_labels(y_true)
    return float((p == t).mean())


def precision(y_pred, y_true, cls=1):
    cm = confusion_matrix(y_pred, y_true)
    denom = cm[:, cls].sum()
    return float(cm[cls, cls] / denom) if denom else 0.0


def recall(y_pred, y_true, cls=1):
    cm = confusion_matrix(y_pred, y_true)
    denom = cm[cls, :].sum()
    return float(cm[cls, cls] / denom) if denom else 0.0


def f1_score(y_pred, y_true, cls=1):
    p = precision(y_pred, y_true, cls)
    r = recall(y_pred, y_true, cls)
    return 2 * p * r / (p + r) if (p + r) else 0.0


def auc(y_score, y_true):
    """ROC AUC by rank statistic (reference metrics.py AUC)."""
    y_score = np.asarray(y_score).reshape(-1)
    y_true = np.asarray(y_true).reshape(-1)
    order = np.argsort(y_score)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(y_score) + 1)
    # average ranks for ties
    uniq, inv, counts = np.unique(y_score, return_inverse=True,
                                  return_counts=True)
    cum = np.cumsum(counts)
    avg_rank = (cum - (counts - 1) / 2.0)
    ranks = avg_rank[inv]
    n_pos = y_true.sum()
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[y_true == 1].sum()
                  - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def softmax(logits, axis=-1):
    """Row-wise softmax (reference metrics.py softmax_func)."""
    z = np.asarray(logits, dtype=np.float64)
    z = z - z.max(axis=axis, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=axis, keepdims=True)


def _threshold_counts(y_score, y_true, thresholds):
    """Vectorized tp/fp counts per threshold via sorted cumulative sums
    (O(n log n) instead of the reference's O(n*T) tiling,
    metrics.py:17-76 — same counts)."""
    s = np.asarray(y_score, dtype=np.float64).reshape(-1)
    t_raw = np.asarray(y_true).reshape(-1)
    # argument order is (scores, labels) — the reverse of the reference's
    # (labels, predictions); a swapped call passes continuous scores
    # here, so insist on binary labels rather than computing garbage
    if not np.isin(t_raw, (0, 1)).all():
        raise ValueError(
            "y_true must be binary 0/1 labels — note hetu_tpu_torch's "
            "threshold metrics take (y_score, y_true), the reverse of "
            "the reference's (labels, predictions) order")
    t = t_raw.astype(bool)
    order = np.argsort(s)
    s_sorted = s[order]
    pos_cum = np.concatenate([[0], np.cumsum(t[order])]).astype(np.float64)
    n, n_pos = len(s), float(t.sum())
    thr = np.asarray(thresholds, dtype=np.float64)
    # predictions > thr are positive: count of scores <= thr per thr
    idx = np.searchsorted(s_sorted, thr, side="right")
    pos_below = pos_cum[idx]               # positives predicted negative
    tp = n_pos - pos_below
    fp = (n - idx) - tp
    fn = pos_below
    tn = idx - fn
    return tp, fp, fn, tn


def confusion_matrix_at_thresholds(y_score, y_true, thresholds,
                                   includes=None):
    """Dict of tp/fn/tn/fp arrays of shape [len(thresholds)] — scores
    above a threshold count as predicted-positive (reference
    metrics.py:17-76)."""
    all_keys = ("tp", "fn", "tn", "fp")
    includes = all_keys if includes is None else tuple(includes)
    for k in includes:
        if k not in all_keys:
            raise ValueError(f"invalid key: {k}")
    tp, fp, fn, tn = _threshold_counts(y_score, y_true, thresholds)
    values = {"tp": tp, "fp": fp, "fn": fn, "tn": tn}
    return {k: values[k] for k in includes}


def roc_pr_curve(values, curve="ROC"):
    """(x, y) of the ROC (fpr, tpr) or PR (recall, precision) curve from
    thresholded confusion counts (reference metrics.py:79-117)."""
    for k in ("tp", "fp", "fn", "tn"):
        if k not in values:
            raise ValueError(f"values must have the key {k}")
    eps = 1.0e-6
    tp, fp, fn, tn = (values[k] for k in ("tp", "fp", "fn", "tn"))
    rec = (tp + eps) / (tp + fn + eps)
    if curve == "ROC":
        return (fp + eps) / (fp + tn + eps), rec
    return rec, (tp + eps) / (tp + fp + eps)


def _default_thresholds(num_thresholds):
    eps = 1e-7
    inner = [(i + 1) / (num_thresholds - 1)
             for i in range(num_thresholds - 2)]
    return np.asarray([-eps] + inner + [1.0 + eps])


def _trapezoid_auc(values, curve):
    x, y = roc_pr_curve(values, curve=curve)
    return float(np.sum((x[:-1] - x[1:]) * (y[:-1] + y[1:]) / 2.0))


def auc_at_thresholds(y_score, y_true, num_thresholds=200, curve="ROC"):
    """Riemann-sum AUC over a threshold grid — ROC or PR (reference
    metrics.py:120-151; the rank-statistic :func:`auc` is exact for ROC,
    this one also covers PR and matches the reference's discretized
    estimate)."""
    thr = _default_thresholds(num_thresholds)
    return _trapezoid_auc(
        confusion_matrix_at_thresholds(y_score, y_true, thr), curve)


def confusion_matrix_one_hot(y_pred, y_true):
    """Per-class tp/fp/tn/fn from score rows and one-hot labels
    (argmax prediction; reference metrics.py:170-217; argument order
    follows this module's pred-first convention)."""
    t = np.asarray(y_true).astype(bool)
    p = np.eye(t.shape[1], dtype=bool)[np.argmax(y_pred, axis=1)]
    return {
        "tp": (t & p).sum(0).astype(np.float64),
        "fp": (~t & p).sum(0).astype(np.float64),
        "tn": (~t & ~p).sum(0).astype(np.float64),
        "fn": (t & ~p).sum(0).astype(np.float64),
    }


def _prf(values, num_key, den_key, average):
    eps = 1.0e-6
    a, b = values[num_key], values[den_key]
    if average == "micro":
        a, b = a.sum(), b.sum()
    score = (a + eps) / (a + b + eps)
    if average == "macro":
        return float(np.mean(score))
    return float(score) if average == "micro" else score


def precision_score(y_pred, y_true, average=None):
    """One-hot precision, per-class / 'micro' / 'macro' (reference
    metrics.py:220-265)."""
    if average not in (None, "micro", "macro"):
        raise ValueError(f"invalid average: {average}")
    return _prf(confusion_matrix_one_hot(y_pred, y_true),
                "tp", "fp", average)


def recall_score(y_pred, y_true, average=None):
    """One-hot recall, per-class / 'micro' / 'macro' (reference
    metrics.py:268-312)."""
    if average not in (None, "micro", "macro"):
        raise ValueError(f"invalid average: {average}")
    return _prf(confusion_matrix_one_hot(y_pred, y_true),
                "tp", "fn", average)


def f_score(y_pred, y_true, beta=1.0, average=None):
    """One-hot F-beta from precision/recall; macro averages the
    per-class F values (reference metrics.py:315-359)."""
    if beta < 0:
        raise ValueError("beta should be >=0 in the F-beta score")
    beta2 = beta * beta
    p = precision_score(y_pred, y_true,
                        average=None if average == "macro" else average)
    r = recall_score(y_pred, y_true,
                     average=None if average == "macro" else average)
    f = (1 + beta2) * p * r / (beta2 * p + r)
    return float(np.mean(f)) if average == "macro" else f


class StreamingAUC:
    """Thresholded-AUC accumulator: per-batch updates add confusion
    counts on a fixed grid, so epoch AUC needs O(num_thresholds) memory
    instead of every score (new capability — the reference recomputes
    from full arrays)."""

    def __init__(self, num_thresholds=200, curve="ROC"):
        self.thresholds = _default_thresholds(num_thresholds)
        self.curve = curve
        self.reset()

    def reset(self):
        z = np.zeros(len(self.thresholds))
        self.counts = {"tp": z.copy(), "fp": z.copy(),
                       "fn": z.copy(), "tn": z.copy()}

    def update(self, y_score, y_true):
        tp, fp, fn, tn = _threshold_counts(y_score, y_true,
                                           self.thresholds)
        self.counts["tp"] += tp
        self.counts["fp"] += fp
        self.counts["fn"] += fn
        self.counts["tn"] += tn

    def result(self):
        return _trapezoid_auc(self.counts, self.curve)


class ConfusionMatrix:
    """Streaming confusion-matrix accumulator."""

    def __init__(self, num_classes):
        self.num_classes = num_classes
        self.cm = np.zeros((num_classes, num_classes), dtype=np.int64)

    def update(self, y_pred, y_true):
        self.cm += confusion_matrix(y_pred, y_true, self.num_classes)

    def accuracy(self):
        total = self.cm.sum()
        return float(np.trace(self.cm) / total) if total else 0.0

    def reset(self):
        self.cm[:] = 0
