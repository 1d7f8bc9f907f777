"""Evaluation metrics (port of multilevel_gnn_tpu/train/metrics.py:12-53,
numpy only; reference train.py:18,103-109,282-285).

AUC/ACC follow the reference protocol exactly:
  y_true = y[:, 0] >= 0.5  (column 0 == high-risk/short-survival class)
  AUC on pred[:, 0]; ACC on pred[:, 0] > 0.5.
"""
from __future__ import annotations

import numpy as np


def roc_auc(y_true: np.ndarray, score: np.ndarray) -> float:
    """Rank-based AUC (equivalent to sklearn.roc_auc_score, ties averaged)."""
    y_true = np.asarray(y_true).astype(bool)
    score = np.asarray(score, np.float64)
    n_pos = int(y_true.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(score, kind="mergesort")
    ranks = np.empty(len(score), np.float64)
    sorted_scores = score[order]
    i = 0
    r = 1.0
    while i < len(score):
        j = i
        while j + 1 < len(score) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        avg = (r + r + (j - i)) / 2.0
        ranks[order[i : j + 1]] = avg
        r += j - i + 1
        i = j + 1
    return float((ranks[y_true].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def accuracy(y_true: np.ndarray, pred_binary: np.ndarray) -> float:
    y_true = np.asarray(y_true).astype(bool)
    return float((y_true == np.asarray(pred_binary).astype(bool)).mean())


def eval_scores(y: np.ndarray, pred: np.ndarray):
    """Reference eval() postprocessing (train.py:103-109).

    y: (N, 2) targets; pred: (N, 2) softmax outputs.
    Returns (auc, acc, y_true, score0)."""
    y_true = y[:, 0] >= 0.5
    score0 = pred[:, 0]
    return (
        roc_auc(y_true, score0),
        accuracy(y_true, score0 > 0.5),
        y_true,
        score0,
    )
