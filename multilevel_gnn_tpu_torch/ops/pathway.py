"""Learnable-PCA pathway contraction (port of multilevel_gnn_tpu/ops/pathway.py).

    out[b, c, s, k] = sum_{g : seg[g]=s}  xg[g, b, c] * P[g, k]

in float32.  xg is node-major (G, B, C) here; the result has the JAX
package's (B, C, S, K) layout.

Two routes, chosen by what the call is:
- a call on one fold runs the PW kernels (ops/kernels/pathway.py) over the
  fold's SlotPlan: each PCA row read once, forward and backward;
- under torch.vmap (the fold-parallel step, whose units each carry their
  own slot ids) the Function's vmap rule takes the dense form, one product
  of the slot one-hot weighted by each PCA column, (K*S, G) @ (G, B*C),
  and counts ``pathway.dense_vmap``.

The JAX package contracts each PCA column k with its own einsum, whose
operand xg is promoted to f32 (pathway.py:49-56).  Its backward therefore
rounds each column's cotangent for xg to xg's dtype and adds the K of them
in that dtype, the last column first; both routes do the same.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from multilevel_gnn_tpu_torch.ops.kernels.pathway import SlotPlan, pathway_bwd, pathway_fwd
from multilevel_gnn_tpu_torch.utils.profiling import count


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


def _dense_contract(x2, p, seg_ids, num_slots: int):
    M = slot_onehot(seg_ids, num_slots)
    W = M[None, :, :] * p.T[:, None, :]  # (K, S, G)
    return _Contract.apply(x2, W)


class _SlotContract(torch.autograd.Function):
    """(K*S, F) f32 contraction of x2 (G, F) with p (G, K) f32 over the
    plan's slots: PW's forward, and both gradients from PW's backward."""

    @staticmethod
    def forward(x2, p, seg_ids, plan: SlotPlan, num_slots: int):
        return pathway_fwd(x2, p, plan)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x2, p, seg_ids, plan, num_slots = inputs
        ctx.save_for_backward(x2, p)
        ctx.plan = plan

    @staticmethod
    def backward(ctx, g):
        x2, p = ctx.saved_tensors
        dx, dp = pathway_bwd(x2, p, g.contiguous(), ctx.plan)
        return dx, dp, None, None, None

    @staticmethod
    def vmap(info, in_dims, x2, p, seg_ids, plan, num_slots):
        # each unit's own slot ids: the dense form, vmapped as it is written
        count("pathway.dense_vmap", 1)
        dense = functools.partial(_dense_contract, num_slots=num_slots)
        return torch.vmap(dense, in_dims=in_dims[:3])(x2, p, seg_ids), 0


def pathway_contract(
    xg: torch.Tensor,
    pca_params: torch.Tensor,
    seg_ids: torch.Tensor,
    num_slots: int,
    plan: Optional[SlotPlan] = None,
) -> torch.Tensor:
    """xg: (G, B, C); pca_params: (G, K) (already masked); seg_ids: (G,)
    slot of each PCA row; plan: SlotPlan.build(seg_ids, num_slots) on xg's
    device (FoldContext.slot_plan), built here from seg_ids when it is not
    given or is another fold's.  Returns (B, C, S, K) float32
    (pathway.py:29)."""
    G, B, C = xg.shape
    K = pca_params.shape[-1]
    if plan is None or plan.num_slots != num_slots or plan.num_rows != G:
        plan = SlotPlan.build(seg_ids, num_slots).to(xg.device)
    x2 = xg.reshape(G, B * C).contiguous()
    out = _SlotContract.apply(x2, pca_params.float().contiguous(), seg_ids, plan, num_slots)
    return out.reshape(K, num_slots, B, C).permute(2, 3, 1, 0)


def slots_to_image(out: torch.Tensor, n_pathways: int) -> torch.Tensor:
    """(B, C, 3*P, K) -> (B, C, P, 3K) (pathway.py:61)."""
    B, C, S, K = out.shape
    if S != 3 * n_pathways:
        raise ValueError(f"{S} slots for {n_pathways} pathways")
    return out.reshape(B, C, n_pathways, 3 * K)
