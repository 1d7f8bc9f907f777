"""Dynamic-graph conv and the residual / dense blocks (port of
multilevel_gnn_tpu/nn/blocks.py: DynConv :18-42, ResDynBlock :45-61,
DenseDynBlock :64-80, ResGraphBlock :83-98, DenseGraphBlock :101-110).

DynConv rebuilds a dilated kNN graph from its input each call when no
graph is given (ops.knn.knn_graph on unbatched (N, C) x) and runs a
GraphConvLayer (module ``body``) on it.  The kNN graph's plans are built
on the device (nn.conv.dynamic_graph), so its max aggregation (edge, mr)
is K3 and its sums and gather backwards K1, where JAX falls back to XLA
for such a graph.  Names follow the flax paths (body.gconv...).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.nn.conv import GraphConvLayer, dynamic_graph
from multilevel_gnn_tpu_torch.ops.knn import knn_graph


class DynConv(nn.Module):
    """forward(x, graph=None): a GraphConvLayer over ``graph``, or over the
    dilated kNN graph of x (N, C), kernel_size neighbours each."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 9,
                 dilation: int = 1, conv: str = "edge", act_type: str = "relu",
                 norm: Optional[str] = None, heads: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        self.body = GraphConvLayer(in_channels, out_channels, conv, act_type, norm,
                                   heads=heads, generator=generator)

    def forward(self, x: torch.Tensor, graph: Optional[Graph] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if graph is None:
            if x.dim() != 2:
                raise ValueError("dynamic knn expects unbatched (N, C)")
            send, recv = knn_graph(x.detach(), self.kernel_size, self.dilation)
            graph = dynamic_graph(send, recv, x.shape[0])
        return self.body(x, graph, None, generator)


class ResDynBlock(nn.Module):
    """DynConv(channels -> channels) + x * res_scale."""

    def __init__(self, channels: int, kernel_size: int = 9, dilation: int = 1,
                 conv: str = "edge", act_type: str = "relu", res_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.res_scale = res_scale
        self.body = DynConv(channels, channels, kernel_size, dilation, conv, act_type,
                            generator=generator)

    def forward(self, x, graph=None, generator=None):
        return self.body(x, graph, generator) + x * self.res_scale


class DenseDynBlock(nn.Module):
    """cat(x, DynConv(in -> out)(x)) over the channels."""

    def __init__(self, in_channels: int, out_channels: int = 64, kernel_size: int = 9,
                 dilation: int = 1, conv: str = "edge", act_type: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.body = DynConv(in_channels, out_channels, kernel_size, dilation, conv, act_type,
                            generator=generator)

    def forward(self, x, graph=None, generator=None):
        return torch.cat([x, self.body(x, graph, generator)], dim=-1)


class ResGraphBlock(nn.Module):
    """GraphConvLayer(channels -> channels) over a given graph + x * res_scale."""

    def __init__(self, channels: int, conv: str = "edge", act_type: str = "relu",
                 heads: int = 8, res_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.res_scale = res_scale
        self.body = GraphConvLayer(channels, channels, conv, act_type, heads=heads,
                                   generator=generator)

    def forward(self, x, graph: Graph, edge_attr=None, generator=None):
        return self.body(x, graph, edge_attr, generator) + x * self.res_scale


class DenseGraphBlock(nn.Module):
    """cat(x, GraphConvLayer(in -> out)(x)) over a given graph."""

    def __init__(self, in_channels: int, out_channels: int, conv: str = "edge",
                 act_type: str = "relu", heads: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.body = GraphConvLayer(in_channels, out_channels, conv, act_type, heads=heads,
                                   generator=generator)

    def forward(self, x, graph: Graph, edge_attr=None, generator=None):
        return torch.cat([x, self.body(x, graph, edge_attr, generator)], dim=-1)
