"""AutoEncoder pretraining model over the MultilevelGNN encoder (port of
multilevel_gnn_tpu/models/autoencoder.py: next_pow2 :30, AutoEncoder
:34-126, reconstruction_loss :125-132).

The encoder is MultilevelGNN's node embedding, GNN stack and learnable-PCA
contraction, with neither dropout on the input nor the value-attention
mask; both of JAX's quirks are kept: pca_match_mask keeps rows with
gene_pca_match > 0, so a PCA row matched to node slot 0 is dropped, and the
PCA params are multiplied by the MI mask whether or not mutual_info_mask
is set.  Decoders: 'flatten' (the (B, C, P, 3K) latent flat -> decoder_dim
-> decoder_dim -> the 3 * node_num node values) or one MLP per non-empty
pathway-omics slot, 'foreach' (hidden decoder_dim) and
'foreach_diffhidden' (hidden next_pow2(sqrt(genes * final_channels))),
reconstructing that slot's PCA-row values.  Subclassing MultilevelGNN
keeps the encoder's parameter names, so train/pretrain.py's transfer
finds them in a classifier.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from multilevel_gnn_tpu_torch.core.batch import Batch, FoldContext
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
from multilevel_gnn_tpu_torch.nn.basic import Linear
from multilevel_gnn_tpu_torch.ops.pathway import pathway_contract


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


class AutoEncoder(MultilevelGNN):
    """forward(batch, ctx, generator) -> (reconstruction, latent).  The
    latent is (B, C, P, 3K) for 'flatten' and (B, C, 3P, K) otherwise;
    the foreach decoders need cfg.slot_sizes (Cohort.slot_sizes())."""

    def _learnable_pca(self) -> bool:
        return True

    def latent_shape(self, width: int) -> Tuple[int, int]:
        """(slots S, width H) of the (B, S, H) latent the VAE / VQ-VAE
        heads see: (P, C * 3K) for 'flatten', (3P, C * K) otherwise."""
        cfg = self.cfg
        if cfg.decoder_type == "flatten":
            return cfg.pathway_num, width * 3 * cfg.pca_dim
        return 3 * cfg.pathway_num, width * cfg.pca_dim

    def _decoder_hidden(self, n_out: int) -> int:
        cfg = self.cfg
        if cfg.decoder_type == "foreach_diffhidden":
            return next_pow2(int(math.sqrt(n_out * cfg.final_channels)))
        return cfg.decoder_dim

    def _build_head(self, width: int, generator) -> None:
        self._build_decoder(width, generator)

    def _build_decoder(self, width: int, generator) -> None:
        cfg = self.cfg
        S, H = self.latent_shape(width)
        if cfg.decoder_type == "flatten":
            dims = (S * H, cfg.decoder_dim, cfg.decoder_dim, cfg.node_num * 3)
            for i in range(3):
                self.add_module(f"dec_{i}", Linear(dims[i], dims[i + 1], kernel_init="xavier",
                                                   generator=generator))
            return
        if cfg.slot_sizes is None:
            raise ValueError("foreach decoders need cfg.slot_sizes (genes per "
                             "pathway-omics slot); set it from Cohort.slot_sizes()")
        self.dec_slots = [s for s in range(S) if int(cfg.slot_sizes[s]) > 0]
        for s in self.dec_slots:
            n_out = int(cfg.slot_sizes[s])
            hidden = self._decoder_hidden(n_out)
            self.add_module(f"dec_slot{s}_0", Linear(H, hidden, kernel_init="xavier",
                                                     generator=generator))
            self.add_module(f"dec_slot{s}_1", Linear(hidden, n_out, kernel_init="xavier",
                                                     generator=generator))

    def forward(self, batch: Batch, ctx: FoldContext,
                generator: Optional[torch.Generator] = None):
        h = self.encode_latent(batch, ctx, generator)
        return self.decode(h), h

    def encode_latent(self, batch: Batch, ctx: FoldContext, generator=None) -> torch.Tensor:
        """The (B, C, P, 3K) or (B, C, 3P, K) float32 latent
        (autoencoder.py:43-84)."""
        cfg = self.cfg
        x = batch.x.T  # (N, B)
        h = x[..., None] * self.node_embedding[:, None, :] if cfg.node_embedding else x[..., None]
        h = self.gnn_stack(h, x, ctx, generator, apply_value_mask=False)
        xg = self.gather_pca_rows(h, ctx, drop_slot0=True)
        p = self.learnable_pca_params * ctx.info_mask
        out = pathway_contract(xg, p, ctx.raw_indice, 3 * cfg.pathway_num)
        if cfg.decoder_type == "flatten":
            B, C, _, K = out.shape
            return out.reshape(B, C, cfg.pathway_num, 3 * K)
        return out

    def decode(self, h: torch.Tensor) -> torch.Tensor:
        """The reconstruction of the latent (B, C, S, K')."""
        if self.cfg.decoder_type == "flatten":
            return self._decode_flat(h.reshape(h.shape[0], -1))
        z = h.permute(0, 2, 1, 3)
        return self._decode_slots(z.reshape(z.shape[0], z.shape[1], -1))

    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        """The reconstruction of a (B, S, H) latent (vae.py:87-116)."""
        if self.cfg.decoder_type == "flatten":
            return self._decode_flat(z.reshape(z.shape[0], -1))
        return self._decode_slots(z)

    def _decode_flat(self, z):
        z = F.relu(self.dec_0(z))
        return self.dec_2(F.relu(self.dec_1(z)))

    def _decode_slots(self, z):
        return torch.cat([
            getattr(self, f"dec_slot{s}_1")(F.relu(getattr(self, f"dec_slot{s}_0")(z[:, s, :])))
            for s in self.dec_slots], dim=-1)


def reconstruction_loss(recon, target, cfg: Config, std_weight=None) -> torch.Tensor:
    """Mean absolute error, weighted per column by std_weight with
    cfg.std_weight (autoencoder.py:125-132)."""
    err = torch.abs(recon - target)
    if cfg.std_weight and std_weight is not None:
        return cfg.std_weight_coef * torch.mean(std_weight[None, :] * err)
    return torch.mean(err)
