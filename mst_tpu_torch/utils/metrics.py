"""Classification metrics: accuracy and exact midrank AUROC on the host.

Counterpart of `mst_tpu/utils/metrics.py` (`binary_auroc`, `accuracy`,
`confusion_matrix`, `cm2acc`, `cm2x`, `ClassificationMetrics`) for a single
process, and of the Youden working point of
`mst_tpu/utils/roc_curve.plot_roc_curve` without its plot; numpy only.
Per-step predictions are a batch of 2 floats, so an epoch's scores and
labels accumulate on the host and the AUC is computed exactly, with ties
taking their midrank (as sklearn's `roc_auc_score`).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def binary_auroc(scores, labels) -> float:
    """Exact AUC via midranks; NaN when one class is absent."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(bool)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    # runs of equal scores share the mean of their 1-based ranks
    starts = np.flatnonzero(np.r_[True, sorted_scores[1:] != sorted_scores[:-1]])
    ends = np.r_[starts[1:], scores.size]
    ranks = np.empty(scores.size, dtype=np.float64)
    ranks[order] = np.repeat(0.5 * (starts + ends - 1) + 1.0, ends - starts)
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def accuracy(pred_classes, labels) -> float:
    pred_classes = np.asarray(pred_classes).ravel()
    labels = np.asarray(labels).ravel()
    return float((pred_classes == labels).mean()) if labels.size else float("nan")


def confusion_matrix(pred, target, n_classes: int = 2) -> np.ndarray:
    """Rows are the ground truth, columns the prediction."""
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (np.asarray(target).ravel().astype(int),
                   np.asarray(pred).ravel().astype(int)), 1)
    return cm


def cm2acc(cm) -> float:
    """Accuracy from a confusion matrix (reference `roc_curve.py:80-85`)."""
    cm = np.asarray(cm)
    return float(np.trace(cm) / max(cm.sum(), 1))


def cm2x(cm):
    """(ppv, npv, sensitivity, specificity) of a 2x2 confusion matrix (rows
    the ground truth, columns the prediction; reference
    `roc_curve.py:88-102`); NaN where a denominator is 0."""
    (tn, fp), (fn, tp) = np.asarray(cm)

    def div(a, b):
        return float(a / b) if b > 0 else float("nan")

    return div(tp, tp + fp), div(tn, tn + fn), div(tp, tp + fn), div(tn, tn + fp)


def youden_working_point(y_true, y_score):
    """(threshold, confusion matrix) at the ROC point of largest Youden J =
    tpr - fpr, as `mst_tpu/utils/roc_curve.plot_roc_curve` picks it from
    sklearn's `roc_curve(drop_intermediate=False)`: the thresholds are +inf
    (nothing positive, J = 0) and every distinct score in decreasing order,
    ties go to the first, a score >= the threshold is positive. Needs both
    classes."""
    y_true = np.asarray(y_true).ravel().astype(int)
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("youden_working_point needs both classes in y_true")
    thr = np.unique(y_score)[::-1]
    at_or_above = y_score[None, :] >= thr[:, None]  # [thresholds, samples]
    tpr = (at_or_above & (y_true == 1)).sum(1) / n_pos
    fpr = (at_or_above & (y_true == 0)).sum(1) / n_neg
    thr = np.r_[np.inf, thr]
    opt = int(np.argmax(np.r_[0.0, tpr - fpr]))
    pred = (y_score >= thr[opt]).astype(int)
    return float(thr[opt]), confusion_matrix(pred, y_true)


class ClassificationMetrics:
    """Streaming epoch accumulator: `update(logits, labels[, valid])` per
    batch, `compute()` -> {"ACC", "AUC_ROC"}. `valid` marks the rows that
    count (False for padding duplicates of the eval stream)."""

    def __init__(self):
        self._scores: List[np.ndarray] = []
        self._preds: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []
        self._valid: List[np.ndarray] = []

    def update(self, logits, labels, valid=None):
        logits = np.asarray(logits, dtype=np.float32)
        labels = np.asarray(labels)
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs = probs / probs.sum(-1, keepdims=True)
        self._scores.append(probs[:, 1] if probs.shape[-1] > 1 else probs[:, 0])
        self._preds.append(logits.argmax(-1))
        self._labels.append(labels)
        self._valid.append(np.ones(labels.shape[0], bool) if valid is None
                           else np.asarray(valid, bool))

    def compute(self) -> Dict[str, float]:
        if not self._labels:
            return {"ACC": float("nan"), "AUC_ROC": float("nan")}
        keep = np.concatenate(self._valid)
        scores = np.concatenate(self._scores)[keep]
        preds = np.concatenate(self._preds)[keep]
        labels = np.concatenate(self._labels)[keep]
        return {"ACC": accuracy(preds, labels),
                "AUC_ROC": binary_auroc(scores, labels)}
