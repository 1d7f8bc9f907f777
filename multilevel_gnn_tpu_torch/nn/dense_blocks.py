"""Dense point-cloud graph blocks, the DeepGCN legacy (port of
multilevel_gnn_tpu/nn/dense_blocks.py :31-299): pairwise_distance,
dense_knn_matrix, dense_dilated, DenseDilatedKnnGraph,
batched_index_select, BasicConv, MRConv2d, EdgeConv2d, GraphConv2d,
DynConv2d, PlainDynBlock2d, ResDynBlock2d, DenseDynBlock2d.

No model calls them and no TPU kernel stands behind them: they are dense
torch ops throughout (a 1 x 1 convolution is a product over the channels,
the neighbour fetch an index gather, the max a reduction).  The public
layout is the reference's channel-first (B, C, N, 1) / (B, C, N, k).
Names follow the flax paths (conv{i} with flax's (1, 1, in, out) kernel as
a (out, in, 1, 1) weight through interop.py, norm{i} a BatchNorm).
Training-mode draws (Dropout2d-style channel dropout, the stochastic
dilation) come from a torch.Generator the caller passes in.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multilevel_gnn_tpu_torch.nn.basic import BatchNorm, leaky_relu


def pairwise_distance(x: torch.Tensor) -> torch.Tensor:
    """(B, N, D) -> (B, N, N) squared distances."""
    inner = -2.0 * torch.einsum("bnd,bmd->bnm", x, x)
    sq = (x * x).sum(-1, keepdim=True)
    return sq + inner + sq.transpose(1, 2)


@torch.no_grad()
def dense_knn_matrix(x: torch.Tensor, k: int = 16) -> torch.Tensor:
    """x (B, C, N, 1) -> (2, B, N, k) int64: (neighbour index, centre
    index), nearest first, self included; no gradient."""
    pts = x.squeeze(-1).transpose(1, 2)  # (B, N, C)
    n = pts.shape[1]
    nn_idx = torch.topk(-pairwise_distance(pts), k, dim=-1).indices
    center = torch.arange(n, device=x.device)[None, :, None].expand(nn_idx.shape)
    return torch.stack([nn_idx, center], dim=0)


def dense_dilated(edge_index: torch.Tensor, k: int, dilation: int = 1,
                  stochastic: bool = False, epsilon: float = 0.0, training: bool = False,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Every dilation-th of the k * dilation neighbours; in stochastic
    training mode with a generator, a random k of them with probability
    epsilon."""
    det = edge_index[..., ::dilation]
    if stochastic and training and generator is not None:
        dev = edge_index.device
        use_random = torch.rand((), generator=generator, device=dev) < epsilon
        randnum = torch.randperm(k * dilation, generator=generator, device=dev)[:k]
        return torch.where(use_random, edge_index.index_select(-1, randnum), det)
    return det


class DenseDilatedKnnGraph(nn.Module):
    """kNN over k * dilation, then dense_dilated."""

    def __init__(self, k: int = 9, dilation: int = 1, stochastic: bool = False,
                 epsilon: float = 0.0):
        super().__init__()
        self.k, self.dilation, self.stochastic, self.epsilon = k, dilation, stochastic, epsilon

    def forward(self, x, generator=None):
        edge_index = dense_knn_matrix(x, self.k * self.dilation)
        return dense_dilated(edge_index, self.k, self.dilation, self.stochastic,
                             self.epsilon, self.training, generator)


def batched_index_select(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, C, N, 1), idx (B, N, k) -> (B, C, N, k) neighbour features."""
    pts = x.squeeze(-1).transpose(1, 2)  # (B, N, C)
    B, N, k = idx.shape
    feat = torch.gather(pts, 1, idx.reshape(B, N * k, 1).expand(B, N * k, pts.shape[-1]))
    return feat.reshape(B, N, k, -1).permute(0, 3, 1, 2)


class _Conv1x1(nn.Module):
    """flax nn.Conv(ch, (1, 1)): weight (out, in, 1, 1), kaiming-normal
    (fan_in) init, optional bias; applied channel-last as a product."""

    def __init__(self, c_in: int, c_out: int, bias: bool, generator):
        super().__init__()
        w = torch.empty(c_out, c_in, 1, 1)
        with torch.no_grad():
            w.normal_(0.0, math.sqrt(2.0 / c_in), generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None

    def forward(self, h):  # (..., C_in) -> (..., C_out)
        return F.linear(h, self.weight[:, :, 0, 0], self.bias)


class BasicConv(nn.Module):
    """1 x 1-conv MLP over (B, C, N, k): per layer conv, act, norm (batch:
    BatchNorm over (B, N, k); instance: over (N, k) per sample, no affine),
    and channel dropout in training mode (whole channels of a sample)."""

    def __init__(self, channels: Sequence[int], act: Optional[str] = "relu",
                 norm: Optional[str] = None, bias: bool = True, drop: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = None if act is None or act.lower() == "none" else act.lower()
        if self.act not in (None, "relu", "leakyrelu"):
            raise NotImplementedError(f"activation [{act}] is not found")
        self.norm = None if norm is None or norm.lower() == "none" else norm.lower()
        if self.norm not in (None, "batch", "instance"):
            raise NotImplementedError(norm)
        self.drop, self.n = drop, len(channels) - 1
        for i, (c_in, c_out) in enumerate(zip(channels[:-1], channels[1:])):
            self.add_module(f"conv{i}", _Conv1x1(c_in, c_out, bias, generator))
            if self.norm == "batch":
                self.add_module(f"norm{i}", BatchNorm(c_out))

    def forward(self, x, generator=None):
        h = x.permute(0, 2, 3, 1)  # (B, N, k, C)
        for i in range(self.n):
            h = getattr(self, f"conv{i}")(h)
            if self.act == "relu":
                h = torch.relu(h)
            elif self.act == "leakyrelu":
                h = leaky_relu(h, 0.2)
            if self.norm == "batch":
                h = getattr(self, f"norm{i}")(h)
            elif self.norm == "instance":
                mu = h.mean(dim=(1, 2), keepdim=True)
                var = h.var(dim=(1, 2), unbiased=False, keepdim=True)
                h = (h - mu) * torch.rsqrt(var + 1e-5)
            if self.drop > 0 and self.training:
                if generator is None:
                    raise ValueError("training-mode dropout needs a torch.Generator")
                keep = 1.0 - self.drop
                mask = torch.rand((h.shape[0], 1, 1, h.shape[3]), generator=generator,
                                  device=h.device) < keep
                h = torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))
        return h.permute(0, 3, 1, 2)


class MRConv2d(nn.Module):
    """Max-relative conv: BasicConv(cat(x, max_k (x_j - x_i)))."""

    def __init__(self, in_channels: int, out_channels: int, act: str = "relu",
                 norm: Optional[str] = None, bias: bool = True, generator=None):
        super().__init__()
        self.nn = BasicConv([in_channels * 2, out_channels], act, norm, bias,
                            generator=generator)

    def forward(self, x, edge_index, generator=None):
        x_i = batched_index_select(x, edge_index[1])
        x_j = batched_index_select(x, edge_index[0])
        rel = (x_j - x_i).amax(-1, keepdim=True)
        return self.nn(torch.cat([x, rel], dim=1), generator)


class EdgeConv2d(nn.Module):
    """Edge conv: max_k BasicConv(cat(x_i, x_j - x_i))."""

    def __init__(self, in_channels: int, out_channels: int, act: str = "relu",
                 norm: Optional[str] = None, bias: bool = True, generator=None):
        super().__init__()
        self.nn = BasicConv([in_channels * 2, out_channels], act, norm, bias,
                            generator=generator)

    def forward(self, x, edge_index, generator=None):
        x_i = batched_index_select(x, edge_index[1])
        x_j = batched_index_select(x, edge_index[0])
        h = self.nn(torch.cat([x_i, x_j - x_i], dim=1), generator)
        return h.amax(-1, keepdim=True)


class GraphConv2d(nn.Module):
    """conv 'edge' or 'mr' (module gconv)."""

    def __init__(self, in_channels: int, out_channels: int, conv: str = "edge",
                 act: str = "relu", norm: Optional[str] = None, bias: bool = True,
                 generator=None):
        super().__init__()
        if conv == "edge":
            self.gconv = EdgeConv2d(in_channels, out_channels, act, norm, bias, generator)
        elif conv == "mr":
            self.gconv = MRConv2d(in_channels, out_channels, act, norm, bias, generator)
        else:
            raise NotImplementedError(f"conv:{conv} is not supported")

    def forward(self, x, edge_index, generator=None):
        return self.gconv(x, edge_index, generator)


class DynConv2d(nn.Module):
    """GraphConv2d (module body) over edge_index, or over the dilated kNN
    graph of x when none is given."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 9,
                 dilation: int = 1, conv: str = "edge", act: str = "relu",
                 norm: Optional[str] = None, bias: bool = True, stochastic: bool = False,
                 epsilon: float = 0.0, generator=None):
        super().__init__()
        self.dilated_knn_graph = DenseDilatedKnnGraph(kernel_size, dilation, stochastic,
                                                      epsilon)
        self.body = GraphConv2d(in_channels, out_channels, conv, act, norm, bias, generator)

    def forward(self, x, edge_index=None, generator=None):
        if edge_index is None:
            edge_index = self.dilated_knn_graph(x, generator)
        return self.body(x, edge_index, generator)


class PlainDynBlock2d(nn.Module):
    """DynConv2d(in -> in)."""

    def __init__(self, in_channels: int, kernel_size: int = 9, dilation: int = 1,
                 conv: str = "edge", act: str = "relu", norm: Optional[str] = None,
                 bias: bool = True, stochastic: bool = False, epsilon: float = 0.0,
                 generator=None):
        super().__init__()
        self.body = DynConv2d(in_channels, in_channels, kernel_size, dilation, conv, act,
                              norm, bias, stochastic, epsilon, generator)

    def forward(self, x, edge_index=None, generator=None):
        return self.body(x, edge_index, generator)


class ResDynBlock2d(PlainDynBlock2d):
    """DynConv2d(in -> in) + x * res_scale."""

    def __init__(self, in_channels: int, kernel_size: int = 9, dilation: int = 1,
                 conv: str = "edge", act: str = "relu", norm: Optional[str] = None,
                 bias: bool = True, stochastic: bool = False, epsilon: float = 0.0,
                 res_scale: float = 1.0, generator=None):
        super().__init__(in_channels, kernel_size, dilation, conv, act, norm, bias,
                         stochastic, epsilon, generator)
        self.res_scale = res_scale

    def forward(self, x, edge_index=None, generator=None):
        return self.body(x, edge_index, generator) + x * self.res_scale


class DenseDynBlock2d(nn.Module):
    """cat(x, DynConv2d(in -> out)(x)) over the channels."""

    def __init__(self, in_channels: int, out_channels: int = 64, kernel_size: int = 9,
                 dilation: int = 1, conv: str = "edge", act: str = "relu",
                 norm: Optional[str] = None, bias: bool = True, stochastic: bool = False,
                 epsilon: float = 0.0, generator=None):
        super().__init__()
        self.body = DynConv2d(in_channels, out_channels, kernel_size, dilation, conv, act,
                              norm, bias, stochastic, epsilon, generator)

    def forward(self, x, edge_index=None, generator=None):
        return torch.cat([x, self.body(x, edge_index, generator)], dim=1)
