"""VQ-VAE pretraining model (port of multilevel_gnn_tpu/models/vq_vae.py:
VectorQuantizer :17-52, VQVAE :55-95, vqvae_loss :98-103).

The AutoEncoder's encoder, its (B, S, H) latent quantised to the nearest
codebook row (L2, first index on ties), commitment and embedding losses
and the straight-through estimator, then the AE's decoders (the foreach
hidden width is decoder_dim even for 'foreach_diffhidden', as in JAX).
The codebook lookup is onehot_embed's product, so its gradient has no
atomics.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from multilevel_gnn_tpu_torch.core.batch import Batch, FoldContext
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.models.autoencoder import AutoEncoder
from multilevel_gnn_tpu_torch.nn.basic import onehot_embed, uniform_


class VectorQuantizer(nn.Module):
    """forward(latents (..., D)) -> (quantised, vq_loss).  The codebook
    ``embedding`` (V, D) starts U(-1, 1)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, beta: float = 0.25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.beta, self.dim = beta, embedding_dim
        self.embedding = nn.Parameter(torch.empty(num_embeddings, embedding_dim))
        uniform_(self.embedding, 1.0, generator)

    def forward(self, latents: torch.Tensor):
        codebook = self.embedding
        flat = latents.reshape(-1, self.dim)
        dist = ((flat ** 2).sum(1, keepdim=True) + (codebook ** 2).sum(1)[None, :]
                - 2.0 * flat @ codebook.T)
        idx = torch.argmin(dist, dim=1)
        quantized = onehot_embed(idx, codebook).reshape(latents.shape)
        commitment = torch.mean((quantized.detach() - latents) ** 2)
        embedding = torch.mean((quantized - latents.detach()) ** 2)
        vq_loss = commitment * self.beta + embedding
        return latents + (quantized - latents).detach(), vq_loss


class VQVAE(AutoEncoder):
    """forward(batch, ctx, generator) -> dict(pred_x, z, quantized,
    vq_loss, embedding)."""

    def _decoder_hidden(self, n_out: int) -> int:
        return self.cfg.decoder_dim

    def _build_head(self, width: int, generator) -> None:
        _, H = self.latent_shape(width)
        self.quantizer = VectorQuantizer(self.cfg.vqvae_num_embeddings, H,
                                         self.cfg.vqvae_beta, generator)
        self._build_decoder(width, generator)

    def forward(self, batch: Batch, ctx: FoldContext,
                generator: Optional[torch.Generator] = None) -> Dict:
        x = self.encode_latent(batch, ctx, generator).permute(0, 2, 1, 3)
        z = x.reshape(x.shape[0], x.shape[1], -1)
        quantized, vq_loss = self.quantizer(z)
        return {"pred_x": self.decode_latent(quantized), "z": z, "quantized": quantized,
                "vq_loss": vq_loss, "embedding": quantized}


def vqvae_loss(recon, target, vq_loss, cfg: Config) -> Dict:
    """mmd_beta * MSE + the VQ loss (vq_vae.py:98-103)."""
    recons_loss = torch.mean((recon - target) ** 2)
    return {"loss": cfg.mmd_beta * recons_loss + vq_loss,
            "Reconstruction_Loss": recons_loss, "VQ_Loss": vq_loss}
