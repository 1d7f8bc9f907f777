"""kNN graph construction (port of multilevel_gnn_tpu/ops/knn.py:
pairwise_sq_dists :16-22, knn_graph :25-62).

Pairwise squared distances in the matmul form, ||a||^2 - 2 a.b + ||b||^2,
then torch.topk of their negation over k * dilation neighbours, self
excluded, nearest first.  Every node receives exactly k edges, in receiver
order, so nn.conv.dynamic_graph builds the kernels' plans from the result
on the device without a copy to the host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """(.., N, D) -> (.., N, N) squared euclidean distances, float32."""
    x = x.float()
    x2 = (x * x).sum(-1)
    inner = torch.einsum("...nd,...md->...nm", x, x)
    return x2[..., :, None] - 2.0 * inner + x2[..., None, :]


def knn_graph(
    x: torch.Tensor,
    k: int,
    dilation: int = 1,
    stochastic: bool = False,
    epsilon: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dilated kNN edges of x (N, D) or (B, N, D): (senders, receivers),
    each (.., N * k), node i's k nearest (every dilation-th of its
    k * dilation nearest) as senders and i as their receiver.  stochastic
    with a generator (a torch.Generator on x's device) and dilation > 1:
    with probability epsilon, a random k of the k * dilation instead, the
    same choice for every node (the reference's DilatedKnnGraph training
    trick).  JAX draws these from its own key, so only the contract is
    shared."""
    d = pairwise_sq_dists(x)
    n = x.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d = torch.where(eye, torch.finfo(d.dtype).max, d)  # exclude self
    kk = k * dilation
    idx = torch.topk(-d, kk, dim=-1).indices  # (.., N, k * dilation), nearest first
    if dilation > 1:
        det = idx[..., ::dilation]
        if stochastic and generator is not None:
            choice = torch.randperm(kk, generator=generator, device=x.device)[:k]
            use_rand = torch.rand((), generator=generator, device=x.device) < epsilon
            idx = torch.where(use_rand, idx.index_select(-1, choice), det)
        else:
            idx = det
    else:
        idx = idx[..., :k]
    recv = torch.arange(n, device=x.device)[:, None].expand(idx.shape)
    return idx.reshape(*idx.shape[:-2], -1), recv.reshape(*recv.shape[:-2], -1)
