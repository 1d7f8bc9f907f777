"""Eval-order batching and evaluation (port of the eval parts of
multilevel_gnn_tpu/train/driver.py: epoch_plan :70, iter_batches :126,
evaluate :167).

A ragged last batch is padded by repeating its last row, with sample_mask
False on the padding rows, so every batch has the same shape.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from multilevel_gnn_tpu_torch.core.batch import Batch, FoldContext
from multilevel_gnn_tpu_torch.train import metrics as M
from multilevel_gnn_tpu_torch.train.step import eval_step


def epoch_plan(idxs, batch_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (take (B,) row indices, sample_mask (B,) bool) per batch, in
    the order of idxs, as the JAX driver's eval order."""
    idxs = np.asarray(idxs)
    for s in range(0, len(idxs), batch_size):
        chunk = idxs[s : s + batch_size]
        b = len(chunk)
        pad = batch_size - b
        take = np.concatenate([chunk, np.repeat(chunk[-1:], pad)]) if pad else chunk
        yield take, np.concatenate([np.ones(b, bool), np.zeros(pad, bool)])


def iter_batches(X, Y, ages, idxs, batch_size: int, device) -> Iterator[Batch]:
    """Batches of host arrays X (P, NODES), Y (P, 2), ages (P,) on device."""
    dev = torch.device(device)
    for take, mask in epoch_plan(idxs, batch_size):
        yield Batch(
            x=torch.as_tensor(np.asarray(X[take], np.float32)).to(dev),
            y=torch.as_tensor(np.asarray(Y[take], np.float32)).to(dev),
            age=torch.as_tensor(np.asarray(ages[take], np.float32)).to(dev),
            sample_mask=torch.as_tensor(mask).to(dev),
        )


def evaluate(model, ctx: FoldContext, X, Y, ages, idxs, batch_size: int):
    """Score idxs in order; returns (auc, acc, y_true, score0, mean loss)
    like the JAX driver's evaluate."""
    preds, losses = [], []
    for batch in iter_batches(X, Y, ages, idxs, batch_size, ctx.device):
        pred, loss = eval_step(model, batch, ctx)
        m = batch.sample_mask.cpu().numpy()
        preds.append(pred.float().cpu().numpy()[m])
        losses.append(float(loss))
    pred = np.concatenate(preds)
    auc, acc, y_true, score0 = M.eval_scores(np.asarray(Y)[idxs], pred)
    return auc, acc, y_true, score0, float(np.mean(losses))
