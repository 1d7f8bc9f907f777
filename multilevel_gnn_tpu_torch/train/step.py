"""Loss, optimizer, train step and eval step (port of
multilevel_gnn_tpu/train/step.py: bce_elementwise :24-55,
classification_loss :58-82, make_optimizer :111-156, make_loss_fn :185-209,
train_step :218-225, eval_step :227-236).

Softmax head + BCELoss on 2-column targets, as the reference, plus the
learnable-PCA feature losses; Adam with coupled L2, an optional global-norm
clip at 20 and the StepLR / warmup schedule of the update count.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from multilevel_gnn_tpu_torch.core.batch import Batch, FoldContext
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.models.multilevel_gnn import get_feature_loss

CLIP_NORM = 20.0


class _BCE(torch.autograd.Function):
    """torch.nn.BCELoss's elementwise term with ATen's log clamp at -100,
    and ATen's backward (binary_cross_entropy_backward):
    d/dp = (p - t) / max(p (1 - p), 1e-12), finite at a saturated softmax
    (p = 0 or 1), where the clamped logs' own derivative is 0 * inf = NaN."""

    @staticmethod
    def forward(ctx, pred, target):
        ctx.save_for_backward(pred, target)
        logp = torch.clamp(torch.log(pred), min=-100.0)
        log1mp = torch.clamp(torch.log(1.0 - pred), min=-100.0)
        return -(target * logp + (1.0 - target) * log1mp)

    @staticmethod
    def backward(ctx, g):
        pred, target = ctx.saved_tensors
        d_pred = g * (pred - target) / torch.clamp(pred * (1.0 - pred), min=1e-12)
        return d_pred, None  # targets are data


def bce_elementwise(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-(t log p + (1 - t) log(1 - p)), logs clamped at -100; gradient as
    ATen's BCE backward."""
    return _BCE.apply(pred, target)


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


def make_lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """Learning rate as a function of the update count, as optax evaluates
    it (step.py:118-135): StepLR as a staircase exponential decay every
    cfg.step epochs; a linear warmup from warmup_lr over warmup_epochs,
    after which the decay starts counting from 0."""

    def decay(count: int) -> float:
        if cfg.step > 0:
            return cfg.lr * cfg.gamma ** math.floor(count / (cfg.step * steps_per_epoch))
        return cfg.lr

    if cfg.warmup_epochs <= 0:
        return decay
    boundary = cfg.warmup_epochs * steps_per_epoch

    def schedule(count: int) -> float:
        if count >= boundary:
            return decay(count - boundary)
        # optax.linear_schedule = polynomial_schedule with power 1
        frac = 1.0 - count / boundary
        return (cfg.warmup_lr - cfg.lr) * frac + cfg.lr

    return schedule


class Optimizer:
    """optax.chain(clip_by_global_norm(20)?, add_decayed_weights(wd)?,
    adam(schedule)) over a module's parameters (step.py:136-156).

    The clip divides by max(norm, 20), optax's form (torch's
    clip_grad_norm_ adds 1e-6 to the norm).  torch.optim.Adam with
    weight_decay is the coupled L2 (wd * p added to the gradient before the
    moments), as the reference trains; its lr is set from the schedule
    before every update.  A parameter without a gradient (a frozen one)
    counts as a zero gradient, as in the JAX tree."""

    def __init__(self, params, cfg: Config, steps_per_epoch: int):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.clip = bool(cfg.clip_grad)
        self.count = 0
        self.adam = torch.optim.Adam(
            self.params, lr=self.schedule(0), betas=(cfg.beta1, cfg.beta2),
            eps=1e-8, weight_decay=cfg.wd,
        )

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip:
            grads = [p.grad for p in self.params]
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads))
            )
            # optax: where(norm < max, g, g / norm * max)
            scale = torch.where(
                norm < CLIP_NORM, torch.ones_like(norm), CLIP_NORM / norm
            )
            torch._foreach_mul_(grads, scale)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1


def make_optimizer(
    model: torch.nn.Module, cfg: Config, steps_per_epoch: int,
    name: Optional[str] = None,
) -> Optimizer:
    """Adam with coupled L2, StepLR and warmup, and the clip when
    cfg.clip_grad (step.py:111-156).  The 'radam' and 'adamw' names of the
    reference's optimizer zoo are not ported yet."""
    name = name or "adam"
    if name != "adam":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet")
    return Optimizer(model.parameters(), cfg, steps_per_epoch)


def make_loss_fn(cfg: Config) -> Callable:
    """The training loss (step.py:185-209): classification loss of the
    training-mode forward plus the feature losses.  Returns
    loss_fn(model, batch, ctx, class_weight, generator) -> (loss, pred)."""

    def loss_fn(model, batch: Batch, ctx: FoldContext, class_weight, generator):
        pred, feat = model(batch, ctx, generator)
        loss = classification_loss(
            pred, batch.y, class_weight, batch.sample_mask, cfg
        )
        loss = loss + get_feature_loss(
            model.learnable_pca_params, ctx, feat, cfg, batch.sample_mask
        )
        return loss, pred

    return loss_fn


def train_step(
    model,
    optimizer: Optimizer,
    batch: Batch,
    ctx: FoldContext,
    class_weight: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """One update in training mode (step.py:218-225); dropout masks come
    from ``generator``.  Returns the loss (a 0-d tensor on the device, not
    synchronised)."""
    model.train()
    optimizer.zero_grad()
    loss, _ = make_loss_fn(model.cfg)(model, batch, ctx, class_weight, generator)
    loss.backward()
    optimizer.step()
    return loss.detach()


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
