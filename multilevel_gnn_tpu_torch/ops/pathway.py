"""Learnable-PCA pathway contraction (port of multilevel_gnn_tpu/ops/pathway.py).

    out[b, c, s, k] = sum_{g : seg[g]=s}  xg[g, b, c] * P[g, k]

computed as one dense product of the slot one-hot matrix weighted by each
PCA column, (K*S, G) @ (G, B*C), in float32.  xg is node-major (G, B, C)
here; the result has the JAX package's (B, C, S, K) layout.
"""
from __future__ import annotations

import torch


def slot_onehot(seg_ids: torch.Tensor, num_slots: int) -> torch.Tensor:
    """(S, G) float32 one-hot assignment; rows = slots, cols = PCA rows."""
    return torch.nn.functional.one_hot(seg_ids.long(), num_slots).T.float()


def pathway_contract(
    xg: torch.Tensor,
    pca_params: torch.Tensor,
    seg_ids: torch.Tensor,
    num_slots: int,
) -> torch.Tensor:
    """xg: (G, B, C); pca_params: (G, K) (already masked); returns
    (B, C, S, K) float32 (pathway.py:29, matmul method)."""
    G, B, C = xg.shape
    K = pca_params.shape[-1]
    M = slot_onehot(seg_ids, num_slots)
    W = M[None, :, :] * pca_params.float().T[:, None, :]  # (K, S, G)
    out = W.reshape(K * num_slots, G) @ xg.reshape(G, B * C).float()
    return out.reshape(K, num_slots, B, C).permute(2, 3, 1, 0)


def slots_to_image(out: torch.Tensor, n_pathways: int) -> torch.Tensor:
    """(B, C, 3*P, K) -> (B, C, P, 3K) (pathway.py:61)."""
    B, C, S, K = out.shape
    if S != 3 * n_pathways:
        raise ValueError(f"{S} slots for {n_pathways} pathways")
    return out.reshape(B, C, n_pathways, 3 * K)
