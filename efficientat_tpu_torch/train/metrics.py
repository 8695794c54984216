"""Evaluation metrics: per-class average precision / ROC-AUC, macro-averaged.

Matches sklearn's ``average_precision_score`` / ``roc_auc_score`` semantics
(the reference's metric source, ex_audioset.py:254-256) — vectorized numpy
over all classes at once instead of a python loop per class, with optional
per-sample weights (OpenMIC's mask-weighted AP, ex_openmic.py:194-204).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def average_precision(y_true: np.ndarray, scores: np.ndarray,
                      sample_weight: Optional[np.ndarray] = None) -> float:
    """AP for one class. Step-interpolated (sklearn) definition:
    AP = sum_n (R_n - R_{n-1}) * P_n over descending-score thresholds."""
    y_true = np.asarray(y_true, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    w = np.ones_like(y_true) if sample_weight is None else np.asarray(sample_weight, np.float64)

    order = np.argsort(-scores, kind="mergesort")
    y, s, w = y_true[order], scores[order], w[order]

    tp = np.cumsum(y * w)
    fp = np.cumsum((1.0 - y) * w)
    # collapse tied thresholds: keep the last entry of each distinct score
    distinct = np.r_[np.nonzero(np.diff(s))[0], len(s) - 1]
    tp, fp = tp[distinct], fp[distinct]
    n_pos = tp[-1]
    if n_pos == 0:
        return 0.0
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / n_pos
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


def roc_auc(y_true: np.ndarray, scores: np.ndarray,
            sample_weight: Optional[np.ndarray] = None) -> float:
    """ROC-AUC via the trapezoidal rule over the weighted ROC curve."""
    y_true = np.asarray(y_true, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    w = np.ones_like(y_true) if sample_weight is None else np.asarray(sample_weight, np.float64)

    order = np.argsort(-scores, kind="mergesort")
    y, s, w = y_true[order], scores[order], w[order]
    tp = np.cumsum(y * w)
    fp = np.cumsum((1.0 - y) * w)
    distinct = np.r_[np.nonzero(np.diff(s))[0], len(s) - 1]
    tp, fp = np.r_[0.0, tp[distinct]], np.r_[0.0, fp[distinct]]
    if tp[-1] == 0 or fp[-1] == 0:
        return float("nan")
    tpr = tp / tp[-1]
    fpr = fp / fp[-1]
    return float(np.trapezoid(tpr, fpr))


def macro_metrics(targets: np.ndarray, scores: np.ndarray,
                  sample_weight: Optional[np.ndarray] = None) -> Tuple[float, float]:
    """(mAP, mean ROC-AUC) macro-averaged over classes.

    targets/scores: (N, C); sample_weight optionally (N, C) (mask-aware,
    OpenMIC) or (N,).
    """
    n_classes = targets.shape[1]
    aps, rocs = [], []
    for c in range(n_classes):
        w = None
        if sample_weight is not None:
            w = sample_weight[:, c] if sample_weight.ndim == 2 else sample_weight
        aps.append(average_precision(targets[:, c], scores[:, c], w))
        rocs.append(roc_auc(targets[:, c], scores[:, c], w))
    return float(np.mean(aps)), float(np.nanmean(rocs))


def accuracy(targets: np.ndarray, scores: np.ndarray) -> float:
    """Single-label accuracy; targets may be class indices or one-hot."""
    if targets.ndim == 2:
        targets = targets.argmax(axis=1)
    return float((scores.argmax(axis=1) == targets).mean())
