"""DiffPool, dense soft-assignment pooling (port of
multilevel_gnn_tpu/models/diffpool.py: DenseSAGEConv :24, SAGEConvolutions
:50, dense_diff_pool :76, DiffPoolLayer :99, DiffPool :114-143).

DenseSAGEConv stacks with BatchNorm and residual, the softmax assignment S,
pooled X' = S^T X and A' = S^T A S, the link loss ||A - S S^T||_F / |A| and
the assignment entropy; levels coarsen by 0.25 (0.1 for a single level).
The JAX package computes every product at Precision.HIGHEST; here they are
float32 products, which stay full f32 on the card while torch's matmul TF32
switch is off (its default).  The levels are small (146 -> 37 -> 10
pathways), so everything stays dense.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.nn.basic import BatchNorm1d, Linear
from multilevel_gnn_tpu_torch.parallel.comm import data_sum


class DenseSAGEConv(nn.Module):
    """PyG's DenseSAGEConv: lin_rel(mean over adj of x) + lin_root(x), then
    L2-normalised rows.  Both Dense layers take torch_linear_init kernels
    and zero biases, flax's nn.Dense default."""

    def __init__(self, in_channels: int, features: int, normalize: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalize = normalize
        self.lin_rel = Linear(in_channels, features, zero_bias=True, generator=generator)
        self.lin_root = Linear(in_channels, features, zero_bias=True, generator=generator)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """x: (B, N, C); adj: (N, N) or (B, N, N)."""
        agg = torch.matmul(adj, x) / torch.clamp(adj.sum(-1, keepdim=True), min=1.0)
        out = self.lin_rel(agg) + self.lin_root(x)
        if self.normalize:
            norm = torch.sqrt((out * out).sum(-1, keepdim=True))
            out = out / torch.clamp(norm, min=1e-12)
        return out


class SAGEConvolutions(nn.Module):
    """(num_layers - 1) x [conv, relu, BatchNorm, residual where the shapes
    match], then a last conv with neither (diffpool.py:50-73)."""

    def __init__(self, num_layers: int, in_channels: int, out_channels: int,
                 residual: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers, self.residual = num_layers, residual
        width = in_channels
        for i in range(num_layers - 1):
            self.add_module(f"conv_{i}", DenseSAGEConv(width, out_channels, generator=generator))
            self.add_module(f"bn_{i}", BatchNorm1d(out_channels))
            width = out_channels
        self.add_module(f"conv_{num_layers - 1}",
                        DenseSAGEConv(width, out_channels, generator=generator))

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers - 1):
            x_new = F.relu(getattr(self, f"conv_{i}")(x, adj))
            x_new = getattr(self, f"bn_{i}")(x_new)
            x = x + x_new if self.residual and x.shape == x_new.shape else x_new
        return getattr(self, f"conv_{self.num_layers - 1}")(x, adj)


def dense_diff_pool(x: torch.Tensor, adj: torch.Tensor, s: torch.Tensor,
                    eps: float = 1e-15, data=None):
    """PyG's dense_diff_pool: (S^T X, S^T A S, link loss, entropy loss) of
    the softmax assignment S = softmax(s) (B, N, K).  data: the fold
    context's DataShard on a data rank of a mesh, whose losses are then
    the whole batch's."""
    s = torch.softmax(s, dim=-1)
    st = s.transpose(-1, -2)
    out = st @ x
    adj_b = adj.expand(s.shape[0], *adj.shape) if adj.dim() == 2 else adj
    out_adj = (st @ adj_b) @ s
    link = adj_b - s @ st
    ent = torch.sum(-s * torch.log(s + eps), dim=-1)
    if data is None or data.size == 1:
        link_loss = torch.sqrt((link * link).sum()) / adj_b.numel()
        ent_loss = torch.mean(ent)
    else:
        link_loss = torch.sqrt(data_sum((link * link).sum(), data)) / (adj_b.numel() * data.size)
        ent_loss = data_sum(ent.sum(), data) / (ent.numel() * data.size)
    return out, out_adj, link_loss, ent_loss


class DiffPoolLayer(nn.Module):
    """One level: the assignment (gnn_pool) and embedding (gnn_embed)
    convs, then dense_diff_pool."""

    def __init__(self, in_channels: int, dim_embedding: int, no_new_clusters: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gnn_pool = SAGEConvolutions(1, in_channels, no_new_clusters, generator=generator)
        self.gnn_embed = SAGEConvolutions(1, in_channels, dim_embedding, generator=generator)

    def forward(self, x, adj, data=None):
        s = self.gnn_pool(x, adj)
        return dense_diff_pool(self.gnn_embed(x, adj), adj, s, data=data)


class DiffPool(nn.Module):
    """The multi-level stack (diffpool.py:114-143): forward(x (B, N, C),
    adj (N, N)) -> (x_coarse, link_loss, entropy_loss), each level followed
    by cfg.after_pooling_layer SAGE convs; out_dim is gnn_output_dim at the
    last level, gnn_hidden_dim before it; data: dense_diff_pool's."""

    def __init__(self, cfg: Config, num_features: int, max_num_nodes: int,
                 num_layers: int, gnn_hidden_dim: int, gnn_output_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        coarse = 0.1 if num_layers == 1 else 0.25
        no_new = math.ceil(coarse * max_num_nodes)
        width = num_features
        self.n_clusters = []
        for i in range(num_layers):
            out_dim = gnn_output_dim if i == num_layers - 1 else gnn_hidden_dim
            self.add_module(f"diffpool_{i}",
                            DiffPoolLayer(width, out_dim, no_new, generator=generator))
            self.add_module(f"after_pool_{i}", SAGEConvolutions(
                cfg.after_pooling_layer, out_dim, out_dim, generator=generator))
            self.n_clusters.append(no_new)
            width = out_dim
            no_new = math.ceil(no_new * coarse)
        self.out_width = self.n_clusters[-1] * width

    def forward(self, x: torch.Tensor, adj: torch.Tensor, data=None):
        l_total = e_total = 0.0
        for i in range(self.num_layers):
            x, adj, l, e = getattr(self, f"diffpool_{i}")(x, adj, data)
            x = getattr(self, f"after_pool_{i}")(x, adj)
            l_total = l_total + l
            e_total = e_total + e
        return x, l_total, e_total
