"""VAE / MMD-WAE pretraining and the VAE classifier (port of
multilevel_gnn_tpu/models/vae.py: VAE :29-200 with encode_gaussian and
decode_latent, VAEClassifier :203-221 with VAE's _finetune and
predict_head,
embedding_reorder :224-248, vae_loss :251-272, _kernel_matrix, and
compute_mmd_per_slot).

Encoder: AutoEncoder's, then the mu and log-sigma heads on the (B, S, H)
latent (sigma = exp(log_sigma) + 1e-7) and the aux losses -std(mu) and the
mean |corr| between latent columns per slot.  JAX's documented divergence
is kept: with decoder_type 'flatten' the latent heads are sized from the
(B, P, C * 3K) input (vae.py:11-15).  The Gaussian draws (z = mu + sigma *
eps, and the MMD prior of each slot) come from an explicit torch.Generator,
or are handed in as ``eps`` / ``prior`` (jax.random's stream cannot be made
in torch).

VAEClassifier (model 'vae_finetune') puts the classifier head on mu: the
(B, H, P, W) image (or (B, 1, P, W) with channel_one), optionally
reordered, into a ConvHead, or with reorder_type 'diff_pooling' into a
DiffPool stack over the fold's pathway_adj, then dropout, age, head_0 /
head_1 and softmax.  It returns (probabilities, image, link + entropy
losses); it has no decoder.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from multilevel_gnn_tpu_torch.core.batch import Batch, FoldContext
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.models.autoencoder import AutoEncoder
from multilevel_gnn_tpu_torch.models.diffpool import DiffPool
from multilevel_gnn_tpu_torch.models.multilevel_gnn import ConvHead
from multilevel_gnn_tpu_torch.nn.basic import Dropout, Linear


def normal(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """N(0, 1) float32 draws from ``generator`` (a generator on ``device``),
    or from one seeded 0 when None, as JAX draws from PRNGKey(0) in eval."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.randn(shape, generator=generator, device=device)


class VAE(AutoEncoder):
    """forward(batch, ctx, generator, eps) -> dict(pred_x, mu, sigma, z,
    aux_losses, embedding)."""

    def _build_head(self, width: int, generator) -> None:
        _, H = self.latent_shape(width)
        self.enc_mu = Linear(H, H, kernel_init="xavier", generator=generator)
        self.enc_log_sigma = Linear(H, H, kernel_init="xavier", generator=generator)
        self._build_decoder(width, generator)

    def forward(self, batch: Batch, ctx: FoldContext,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> Dict:
        """eps: the (B, S, H) N(0, 1) draws of z; drawn from generator when
        None."""
        mu, sigma, aux = self.encode_gaussian(batch, ctx, generator)
        if eps is None:
            eps = normal(mu.shape, generator, mu.device)
        z = mu + sigma * eps
        return {
            "pred_x": self.decode_latent(z),
            "mu": mu,
            "sigma": sigma,
            "z": z,
            "aux_losses": aux,
            "embedding": torch.cat([mu, sigma], dim=-1),
        }

    def encode_gaussian(self, batch: Batch, ctx: FoldContext, generator=None):
        """(mu, sigma, aux losses) on the (B, S, H) latent (vae.py:62-84)."""
        h = self.encode_latent(batch, ctx, generator)
        x = h.permute(0, 2, 1, 3)
        x = x.reshape(x.shape[0], x.shape[1], -1)
        mu = self.enc_mu(x)
        sigma = torch.exp(self.enc_log_sigma(x)) + 1e-7
        loss_std = -torch.std(mu.reshape(mu.shape[0], -1), dim=0, correction=1).mean()
        m = mu - mu.mean(dim=0, keepdim=True)  # the correlation over the batch, per slot
        cov = torch.einsum("bsh,bsg->shg", m, m)
        d = torch.sqrt(torch.clamp(torch.einsum("bsh,bsh->sh", m, m), min=1e-12))
        corr = cov / (d[:, :, None] * d[:, None, :])
        eye = torch.eye(mu.shape[-1], device=mu.device)[None]
        loss_corr = torch.abs(corr * (1.0 - eye)).mean()
        return mu, sigma, {"std": loss_std, "idp": 0.0, "corr": loss_corr}


class VAEClassifier(VAE):
    """The VAE's classifier under the CV driver (model 'vae_finetune'):
    forward(batch, ctx, generator) -> (pred, image, DiffPool link +
    entropy losses, 0 for the ConvHead)."""

    def _build_head(self, width: int, generator) -> None:
        cfg = self.cfg
        S, H = self.latent_shape(width)
        self.enc_mu = Linear(H, H, kernel_init="xavier", generator=generator)
        self.enc_log_sigma = Linear(H, H, kernel_init="xavier", generator=generator)
        P = cfg.pathway_num
        ch, w = (1, S * H // P) if cfg.channel_one else (H, S // P)
        if cfg.reorder_type != "diff_pooling":
            self.conv_head = ConvHead(cfg, ch, generator, width=w)
            return
        self.diff_pooling = DiffPool(
            cfg, ch, P, cfg.diff_pooling_layer, cfg.diff_pooling_hidden_dim,
            cfg.diff_pooling_output_dim, generator=generator)
        flat = w * self.diff_pooling.out_width + (1 if cfg.use_age else 0)
        self.feature_drop = Dropout(0.25 if cfg.feature_drop else 0.0)
        self.head_0 = Linear(flat, cfg.head_dim, kernel_init="xavier", generator=generator)
        self.head_drop = Dropout(0.5)
        self.head_1 = Linear(cfg.head_dim, 2, kernel_init="xavier", generator=generator)

    def forward(self, batch: Batch, ctx: FoldContext,
                generator: Optional[torch.Generator] = None):
        pred, img, l, e = self._finetune(batch, ctx, generator)
        return pred, img, l + e

    def _finetune(self, batch: Batch, ctx: FoldContext, generator=None):
        """The classifier on mu (vae.py:119-145): (pred, image, link loss,
        entropy loss)."""
        cfg = self.cfg
        h, _, _ = self.encode_gaussian(batch, ctx, generator)
        B, _, Ch = h.shape
        if cfg.channel_one:
            img = h.reshape(B, 1, cfg.pathway_num, -1)
        else:
            img = h.permute(0, 2, 1).reshape(B, Ch, cfg.pathway_num, -1)
        if cfg.reorder_pathway:
            img = img.index_select(2, ctx.reorder_idxs)
        return self.predict_head(img, batch.age, ctx.pathway_adj, generator)

    def predict_head(self, img, age, pathway_adj, generator=None):
        """vae.py:147-184: DiffPool over the pathways of each image column
        with reorder_type 'diff_pooling', else the ConvHead."""
        cfg = self.cfg
        if cfg.reorder_type != "diff_pooling":
            return self.conv_head(img, age, generator), img, 0.0, 0.0
        B, C, P, D = img.shape
        x = img.permute(0, 3, 2, 1).reshape(-1, P, C)
        x, l, e = self.diff_pooling(x, pathway_adj)
        x = self.feature_drop(x.reshape(B, -1), generator)
        if cfg.use_age:
            x = torch.cat([x, age[:, None].to(x.dtype)], dim=-1)
        x = self.head_drop(F.relu(self.head_0(x)), generator)
        return torch.softmax(self.head_1(x), dim=-1), img, l, e


def embedding_reorder(embeddings) -> np.ndarray:
    """Pathway order from per-omics (P, d) embedding matrices
    (vae.py:224-248): the correlation chain over their concatenation."""
    cat = np.concatenate(
        [np.asarray(e).reshape(np.asarray(e).shape[0], -1) for e in embeddings], axis=-1)
    P = cat.shape[0]
    corr = np.nan_to_num(np.corrcoef(cat) - np.eye(P), nan=-1.0)
    mx = corr.argmax()
    order = [mx // P, mx % P]
    remain = set(range(P)) - set(order)
    sort_m = np.argsort(corr)
    while len(order) < P:
        for t in sort_m[order[-1]][::-1]:
            if t in remain:
                order.append(int(t))
                remain.remove(int(t))
                break
    return np.array(order, np.int32)


def vae_loss(recon, target, z, mu, sigma, cfg: Config,
             generator: Optional[torch.Generator] = None,
             prior: Optional[torch.Tensor] = None) -> Dict:
    """The MMD-WAE objective (vae.py:251-272): mmd_beta * MSE, the KL of
    N(mu, sigma) to N(0, 1) and the per-slot MMD against prior draws."""
    b = target.shape[0]
    recons_loss = torch.mean((recon - target) ** 2)
    mmd = compute_mmd_per_slot(z, cfg, generator, prior)
    kld = ((sigma ** 2 + mu ** 2) / 2.0 - 0.5 - torch.log(sigma)).sum(-1).mean()
    loss = (
        cfg.mmd_beta * recons_loss
        + (1.0 - cfg.mmd_alpha) * cfg.kld_weight * kld
        + (cfg.mmd_alpha + cfg.mmd_reg_weight - 1.0) / (b * (b - 1)) * mmd
    )
    return {"loss": loss, "Reconstruction_Loss": recons_loss, "MMD": mmd, "KLD": -kld}


def _kernel_matrix(x1, x2, cfg: Config):
    """Per slot, x1 and x2 (S, B, H): rbf's (S, B, B) kernel, or imq's sum
    over the off-diagonal pairs (S,) (the diagonal masked with 1 - I)."""
    d = x2.shape[-1]
    diff = x1[:, :, None] - x2[:, None]
    if cfg.mmd_kernel_type == "rbf":
        return torch.exp(-torch.mean(diff ** 2, -1) / (2.0 * d * cfg.z_var))
    C = 2.0 * d * cfg.z_var
    k = C / (1e-7 + C + torch.sum(diff ** 2, -1))
    return torch.sum(k * (1.0 - torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)),
                     dim=(-2, -1))


def compute_mmd_per_slot(z, cfg: Config, generator: Optional[torch.Generator] = None,
                         prior: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over the latent slots of MMD(z[:, s], N(0, 1) draws).  prior:
    the (S, B, H) draws, one (B, H) block a slot; drawn from generator when
    None."""
    zs = z.permute(1, 0, 2)
    if prior is None:
        prior = normal(zs.shape, generator, z.device)

    def term(a, b):
        k = _kernel_matrix(a, b, cfg)
        return k.mean(dim=(-2, -1)) if cfg.mmd_kernel_type == "rbf" else k

    vals = term(prior, prior) + term(zs, zs) - 2 * term(prior, zs)
    return vals.mean()
