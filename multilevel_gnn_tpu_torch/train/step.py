"""Loss and eval step, forward only (port of multilevel_gnn_tpu/train/step.py:
bce_elementwise :24-38, classification_loss :58-82, eval_step :227-236).

Softmax head + BCELoss on 2-column targets, as the reference.  The
optimizer and train step come with the backward pass.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from multilevel_gnn_tpu_torch.core.batch import Batch, FoldContext
from multilevel_gnn_tpu_torch.core.config import Config


def bce_elementwise(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch.nn.BCELoss elementwise term with ATen's log clamp at -100."""
    logp = torch.clamp(torch.log(pred), min=-100.0)
    log1mp = torch.clamp(torch.log(1.0 - pred), min=-100.0)
    return -(target * logp + (1.0 - target) * log1mp)


def classification_loss(
    pred: torch.Tensor,
    y: torch.Tensor,
    class_weight: Optional[torch.Tensor],
    sample_mask: torch.Tensor,
    cfg: Config,
) -> torch.Tensor:
    """Reference weighting variants: weight_balance (per output column),
    weighted_loss / batch_weighted_loss (per sample by true class); padding
    rows masked out of the mean."""
    el = bce_elementwise(pred, y)  # (B, 2)
    m = sample_mask.to(pred.dtype)[:, None]
    denom = torch.clamp(m.sum() * el.shape[1], min=1.0)
    if cfg.weighted_loss or cfg.batch_weighted_loss:
        cls = (y[:, 1] == 1).long()
        w = class_weight[cls][:, None]
        if cfg.batch_weighted_loss:
            w = torch.mean(w) * torch.ones_like(w)
        return (w * el * m).sum() / denom
    if cfg.weight_balance and class_weight is not None:
        return (class_weight[None, :] * el * m).sum() / denom
    return (el * m).sum() / denom


@torch.no_grad()
def eval_step(model, batch: Batch, ctx: FoldContext
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pred (B, 2), loss) in eval mode, class weighting off."""
    was_training = model.training
    model.eval()
    try:
        pred = model(batch, ctx)[0]
    finally:
        model.train(was_training)
    cfg = model.cfg.replace(
        weight_balance=False, weighted_loss=False, batch_weighted_loss=False
    )
    return pred, classification_loss(pred, batch.y, None, batch.sample_mask, cfg)
