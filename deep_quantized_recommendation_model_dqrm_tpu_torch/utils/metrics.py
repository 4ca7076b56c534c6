"""Evaluation metrics: accuracy, ROC AUC, precision/recall/F1/AP.

Replaces the reference's sklearn.metrics usage in `inference()`
(dlrm_s_pytorch.py:833-860) with dependency-free numpy implementations
(sklearn is not needed; AUC agreement is unit-tested against a direct
rank-statistic computation). All operate on host numpy arrays — eval scores
are gathered once per test pass, not per batch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def accuracy(scores: np.ndarray, targets: np.ndarray, threshold: float = 0.5) -> float:
    """Fraction of correct round(score) predictions (dlrm_s_pytorch.py:804:
    `S_test = Z_test.round()`)."""
    pred = (np.asarray(scores) >= threshold).astype(np.float64)
    return float(np.mean(pred == np.asarray(targets)))


def roc_auc(scores: np.ndarray, targets: np.ndarray) -> float:
    """ROC AUC via the Mann-Whitney U rank statistic (equivalent to
    sklearn.metrics.roc_auc_score, incl. tie handling via mid-ranks)."""
    s = np.asarray(scores, np.float64).ravel()
    t = np.asarray(targets).ravel().astype(bool)
    n_pos = int(t.sum())
    n_neg = t.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(s.size, np.float64)
    sorted_s = s[order]
    # mid-ranks for ties
    i = 0
    while i < s.size:
        j = i
        while j + 1 < s.size and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    sum_pos = ranks[t].sum()
    return float((sum_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def binary_metrics(
    scores: np.ndarray, targets: np.ndarray, threshold: float = 0.5
) -> Dict[str, float]:
    """The mlperf-logging metric set (dlrm_s_pytorch.py:833-848): recall,
    precision, f1, average precision, roc_auc, accuracy, loss counts."""
    s = np.asarray(scores, np.float64).ravel()
    t = np.asarray(targets, np.float64).ravel()
    pred = (s >= threshold).astype(np.float64)
    tp = float(np.sum((pred == 1) & (t == 1)))
    fp = float(np.sum((pred == 1) & (t == 0)))
    fn = float(np.sum((pred == 0) & (t == 1)))
    recall = tp / max(tp + fn, 1e-12)
    precision = tp / max(tp + fp, 1e-12)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    # average precision (step-wise integral of the PR curve, sklearn-style)
    order = np.argsort(-s, kind="mergesort")
    t_sorted = t[order]
    cum_tp = np.cumsum(t_sorted)
    prec_at_k = cum_tp / (np.arange(t_sorted.size) + 1.0)
    n_pos = max(float(t.sum()), 1e-12)
    ap = float(np.sum(prec_at_k * t_sorted) / n_pos)
    return {
        "recall": recall,
        "precision": precision,
        "f1": f1,
        "ap": ap,
        "roc_auc": roc_auc(s, t),
        "accuracy": accuracy(s, t, threshold),
    }
