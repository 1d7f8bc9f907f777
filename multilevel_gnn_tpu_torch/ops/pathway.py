"""Learnable-PCA pathway contraction (port of multilevel_gnn_tpu/ops/pathway.py).

    out[b, c, s, k] = sum_{g : seg[g]=s}  xg[g, b, c] * P[g, k]

computed as one dense product of the slot one-hot matrix weighted by each
PCA column, (K*S, G) @ (G, B*C), in float32.  xg is node-major (G, B, C)
here; the result has the JAX package's (B, C, S, K) layout.

The JAX package contracts each PCA column k with its own einsum, whose
operand xg is promoted to f32 (pathway.py:49-56).  Its backward therefore
rounds each column's cotangent for xg to xg's dtype and adds the K of them
in that dtype, the last column first; _Contract's backward does the same.
"""
from __future__ import annotations

import torch


def slot_onehot(seg_ids: torch.Tensor, num_slots: int) -> torch.Tensor:
    """(S, G) float32 one-hot assignment; rows = slots, cols = PCA rows
    (a comparison, which torch.vmap batches over per-unit ids)."""
    slots = torch.arange(num_slots, device=seg_ids.device)
    return (seg_ids.long()[None, :] == slots[:, None]).float()


class _Contract(torch.autograd.Function):
    """(K*S, G) @ x2.float() with x2 (G, F) in any dtype; the gradient of
    x2 in JAX's per-column form, that of W (K, S, G) in f32.  Under
    torch.vmap (the fold-parallel step) both sides are vmapped as written,
    so each unit's backward keeps the per-column rounding."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x2, W):
        K, S, G = W.shape
        return W.reshape(K * S, G) @ x2.float()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x2, W = ctx.saved_tensors
        K, S, G = W.shape
        dx = dW = None
        if ctx.needs_input_grad[0]:
            gk = g.reshape(K, S, -1)
            for k in reversed(range(K)):
                d = (W[k].T @ gk[k]).to(x2.dtype)
                dx = d if dx is None else dx + d
        if ctx.needs_input_grad[1]:
            dW = (g @ x2.float().T).reshape(K, S, G)
        return dx, dW


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
    out = _Contract.apply(xg.reshape(G, B * C), W)
    return out.reshape(K, num_slots, B, C).permute(2, 3, 1, 0)


def slots_to_image(out: torch.Tensor, n_pathways: int) -> torch.Tensor:
    """(B, C, 3*P, K) -> (B, C, P, 3K) (pathway.py:61)."""
    B, C, S, K = out.shape
    if S != 3 * n_pathways:
        raise ValueError(f"{S} slots for {n_pathways} pathways")
    return out.reshape(B, C, n_pathways, 3 * K)
