"""Serving entry: score a patient index set over a fold context (port of
multilevel_gnn_tpu/train/predict.py:102-135 predict_fold, from the point
where the fold context and parameters exist).

Re-deriving a fold from a cohort and loading a checkpoint are not ported
yet; the caller passes the model (with its parameters) and the context.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from multilevel_gnn_tpu_torch.core.batch import FoldContext
from multilevel_gnn_tpu_torch.train.driver import evaluate


def predict_patients(
    model, ctx: FoldContext, X: np.ndarray, Y: np.ndarray, ages: np.ndarray, idx
) -> Dict:
    """Probabilities of class 0 and AUC/ACC/loss for patients ``idx``, in
    batches of the model config's batch_size.

    X (P, NODES), Y (P, 2), ages (P,) are host arrays; the model and ctx
    sit on the device they run on.  "patients" lists the scored row
    indices."""
    idx = np.asarray(idx)
    auc, acc, y_true, score, loss = evaluate(
        model, ctx, X, Y, ages, idx, model.cfg.batch_size
    )
    return {
        "patients": [int(i) for i in idx],
        "prob": [float(p) for p in score],
        "y_true": [int(v) for v in y_true],
        "auc": float(auc),
        "acc": float(acc),
        "loss": float(loss),
    }
