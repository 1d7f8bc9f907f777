"""Reconstruction pretraining and the encoder transfer (port of
multilevel_gnn_tpu/train/pretrain.py: build_pretrain :42-201,
pretrain_autoencoder :204-229, transfer_pretrained :232-250).

  1. pretrain_autoencoder trains an AutoEncoder, VAE (also 'mmd_vae') or
     VQVAE on fold 0 of all the cohort's patients: 'flatten' decoders
     reconstruct the node values batch.x, the foreach decoders the PCA-row
     values batch.raw_data.  Plain Adam (lr, beta1, beta2; no clip, decay
     or schedule, as optax.adam), one np.random.RandomState(seed)
     permutation an epoch, full batches only.  JAX's epoch_scan changes
     only how the same steps are dispatched, so there is one loop here.
  2. transfer_pretrained copies every state_dict entry whose name and
     shape match into a fold's model (node embedding, GNN stack, learnable
     PCA, the VAE's latent heads): the reference's strict=False load.

The dropout masks and the VAE's Gaussian draws come from a torch.Generator
seeded with cfg.seed.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from multilevel_gnn_tpu_torch.core.batch import Batch, FoldContext
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.models.autoencoder import AutoEncoder, reconstruction_loss
from multilevel_gnn_tpu_torch.models.multilevel_gnn import seed_pca_params
from multilevel_gnn_tpu_torch.models.vae import VAE, vae_loss
from multilevel_gnn_tpu_torch.models.vq_vae import VQVAE, vqvae_loss

log = logging.getLogger(__name__)

KINDS = {"autoencoder": AutoEncoder, "vae": VAE, "mmd_vae": VAE, "vq_vae": VQVAE}


def new_pretrain_model(kind: str, cfg: Config, ctx: FoldContext, seed: int):
    """The pretraining model of ``kind`` with its parameters drawn from
    ``seed`` (the tests replace this function to start from the JAX
    package's parameters)."""
    return KINDS[kind](cfg, ctx.graph.n_nodes, ctx.num_pca_rows, device=ctx.device, seed=seed)


def pretrain_loss(model, kind: str, batch: Batch, ctx: FoldContext,
                  std_weight: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None,
                  prior: Optional[torch.Tensor] = None):
    """(loss, parts) of one training-mode forward (pretrain.py:92-126).
    std_weight: Cohort.gene_std_value on the device; eps / prior: the
    VAE's draws (VAE.forward, compute_mmd_per_slot), from ``generator``
    when None."""
    cfg = model.cfg
    target = batch.x if cfg.decoder_type == "flatten" else batch.raw_data
    if kind == "autoencoder":
        recon, h = model(batch, ctx, generator)
        loss = reconstruction_loss(
            recon, target, cfg,
            std_weight if cfg.std_weight and cfg.decoder_type != "flatten" else None)
        parts = {"recon": loss}
        if cfg.pretrain_std_loss:
            std = torch.std(h.reshape(h.shape[0], -1), dim=0, correction=1)
            loss = loss - cfg.pretrain_std_coef * torch.log(std.mean())
        return loss, parts
    if kind in ("vae", "mmd_vae"):
        out = model(batch, ctx, generator, eps=eps)
        parts = vae_loss(out["pred_x"], target, out["z"], out["mu"], out["sigma"], cfg,
                         generator, prior)
        loss = parts["loss"]
        if cfg.pretrain_std_loss:
            loss = loss + cfg.pretrain_std_coef * out["aux_losses"]["std"]
        if cfg.pretrain_corr_loss:
            loss = loss + cfg.pretrain_corr_coef * out["aux_losses"]["corr"]
        return loss, parts
    out = model(batch, ctx, generator)
    parts = vqvae_loss(out["pred_x"], target, out["vq_loss"], cfg)
    return parts["loss"], parts


def pretrain_step(model, optimizer, kind: str, batch: Batch, ctx: FoldContext,
                  std_weight=None, generator=None) -> torch.Tensor:
    """One Adam update on pretrain_loss in training mode; returns the loss
    (a 0-d tensor on the device, not synchronised)."""
    model.train()
    optimizer.zero_grad()
    loss, _ = pretrain_loss(model, kind, batch, ctx, std_weight, generator)
    loss.backward()
    optimizer.step()
    return loss.detach()


def make_pretrain_optimizer(model, cfg: Config) -> torch.optim.Adam:
    """optax.adam(lr, b1, b2): eps 1e-8, no decay, clip or schedule."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(cfg.beta1, cfg.beta2),
                            eps=1e-8)


def build_pretrain(cfg: Config, cohort, kind: str = "autoencoder", fold_i: int = 0,
                   device="cuda") -> Dict:
    """Fold fold_i over all patients, the config with the cohort's counts
    and slot sizes, the model (PCA-seeded with init_with_pca), and the
    PCA-row values per patient.  Returns a dict with cfg, model, ctx,
    fold and raw."""
    if kind not in KINDS:
        raise ValueError(f"pretrain kind {kind!r} (one of {sorted(KINDS)})")
    train_idx = np.arange(len(cohort.patients))
    fold = cohort.fold(train_idx, fold_i, device=device)
    cfg = cfg.replace(pathway_num=cohort.n_pathways, node_num=cohort.num_nodes // 3,
                      slot_sizes=cohort.slot_sizes())
    ctx = fold.ctx
    model = new_pretrain_model(kind, cfg, ctx, cfg.seed)
    if cfg.init_with_pca and ctx.pca_seed is not None:
        seed_pca_params(model, ctx.pca_seed)
    pos = {p: i for i, p in enumerate(cohort.pca_patients)}
    raw = cohort.raw_datas[[pos[p] for p in cohort.patients]].astype(np.float32)
    return dict(cfg=cfg, model=model, ctx=ctx, fold=fold, raw=raw)


def pretrain_autoencoder(cfg: Config, cohort, kind: str = "autoencoder",
                         epochs: Optional[int] = None, fold_i: int = 0, device="cuda"):
    """Train a pretraining model on the cohort (pretrain.py:204-229);
    returns (model, ctx, fold, mean loss per epoch)."""
    s = build_pretrain(cfg, cohort, kind, fold_i, device)
    cfg, model, ctx = s["cfg"], s["model"], s["ctx"]
    dev = ctx.device
    epochs = epochs or cfg.epochs
    optimizer = make_pretrain_optimizer(model, cfg)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)

    def on(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    X, Y, ages, raw = on(cohort.X), on(cohort.Y), on(cohort.ages), on(s["raw"])
    std_w = on(cohort.gene_std_value)
    np_rng = np.random.RandomState(cfg.seed)
    n, B = len(cohort.patients), cfg.batch_size
    mask = torch.ones(B, dtype=torch.bool, device=dev)
    epoch_losses = []
    for epoch in range(1, epochs + 1):
        order = torch.as_tensor(np_rng.permutation(n)).to(dev)
        losses = []
        for off in range(0, n - B + 1, B):
            take = order[off: off + B]
            batch = Batch(x=X[take], y=Y[take], age=ages[take], sample_mask=mask,
                          raw_data=raw[take])
            losses.append(pretrain_step(model, optimizer, kind, batch, ctx, std_w, generator))
        mean = float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64))
                     ) if losses else float("nan")
        epoch_losses.append(mean)
        log.info("pretrain %s epoch %d loss %.5f", kind, epoch, mean)
    return model, ctx, s["fold"], epoch_losses


@torch.no_grad()
def transfer_pretrained(pre_state: Dict[str, torch.Tensor], model: torch.nn.Module) -> int:
    """Copy every entry of a pretrained model's state_dict whose name and
    shape match into ``model``'s parameters and buffers in place
    (pretrain.py:232-250); returns the number copied."""
    own = model.state_dict()
    copied = 0
    for name, t in own.items():
        src = pre_state.get(name)
        if src is not None and tuple(src.shape) == tuple(t.shape):
            t.copy_(src.to(t.device, t.dtype))
            copied += 1
    log.info("transferred %d/%d parameter leaves", copied, len(own))
    return copied
