"""Threshold-free and threshold metrics used by the paper (§3.6):
AUROC, AUPRC, F1-score, Cohen's kappa.  Pure numpy (evaluation-time)."""

from __future__ import annotations

import numpy as np


def auroc(labels, scores) -> float:
    """Rank-based (Mann-Whitney) AUROC, tie-aware."""
    labels = np.asarray(labels).astype(bool).ravel()
    scores = np.asarray(scores, np.float64).ravel()
    n_pos, n_neg = labels.sum(), (~labels).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    r = 1.0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * ((i + 1) + (j + 1))
        i = j + 1
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def auprc(labels, scores) -> float:
    """Average precision (step-wise integration of the PR curve).

    Tied scores are integrated as ONE threshold group (sklearn's
    convention), so the value is invariant to the input ordering of ties.
    """
    labels = np.asarray(labels).astype(bool).ravel()
    scores = np.asarray(scores, np.float64).ravel()
    n_pos = labels.sum()
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-scores, kind="mergesort")
    lab, s = labels[order], scores[order]
    ends = np.append(np.where(np.diff(s))[0], len(s) - 1)   # group ends
    tp = np.cumsum(lab)[ends]
    precision = tp / (ends + 1.0)
    recall_delta = np.diff(np.concatenate([[0], tp])) / n_pos
    return float((precision * recall_delta).sum())


def confusion(labels, scores, threshold=0.5):
    labels = np.asarray(labels).astype(bool).ravel()
    pred = np.asarray(scores).ravel() >= threshold
    tp = int((pred & labels).sum())
    fp = int((pred & ~labels).sum())
    fn = int((~pred & labels).sum())
    tn = int((~pred & ~labels).sum())
    return tp, fp, fn, tn


def f1_score(labels, scores, threshold=0.5) -> float:
    tp, fp, fn, _ = confusion(labels, scores, threshold)
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom else float("nan")


def kappa(labels, scores, threshold=0.5) -> float:
    tp, fp, fn, tn = confusion(labels, scores, threshold)
    n = tp + fp + fn + tn
    po = (tp + tn) / n
    pe = ((tp + fp) * (tp + fn) + (fn + tn) * (fp + tn)) / (n * n)
    return float((po - pe) / (1 - pe)) if pe < 1 else float("nan")


def sensitivity(labels, scores, threshold=0.5) -> float:
    """True positive rate (recall) — the screening-critical number."""
    tp, _, fn, _ = confusion(labels, scores, threshold)
    return float(tp / (tp + fn)) if tp + fn else float("nan")


def specificity(labels, scores, threshold=0.5) -> float:
    """True negative rate."""
    _, fp, _, tn = confusion(labels, scores, threshold)
    return float(tn / (tn + fp)) if tn + fp else float("nan")


def expected_calibration_error(labels, scores, n_bins=10) -> float:
    """ECE: confidence-weighted |accuracy - confidence| over equal-width
    probability bins (Guo et al. 2017, binary form on P(y=1))."""
    labels = np.asarray(labels).astype(np.float64).ravel()
    scores = np.asarray(scores, np.float64).ravel()
    if len(labels) == 0:
        return float("nan")
    bins = np.clip((scores * n_bins).astype(int), 0, n_bins - 1)
    ece = 0.0
    for b in range(n_bins):
        sel = bins == b
        if not sel.any():
            continue
        ece += sel.mean() * abs(labels[sel].mean() - scores[sel].mean())
    return float(ece)


def all_metrics(labels, scores, threshold=0.5) -> dict:
    return {"auroc": auroc(labels, scores),
            "auprc": auprc(labels, scores),
            "f1": f1_score(labels, scores, threshold),
            "kappa": kappa(labels, scores, threshold),
            "sensitivity": sensitivity(labels, scores, threshold),
            "specificity": specificity(labels, scores, threshold),
            "ece": expected_calibration_error(labels, scores)}
