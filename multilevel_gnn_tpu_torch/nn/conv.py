"""The SAGE convolution of the shipped configs (port of
multilevel_gnn_tpu/nn/conv.py: RSAGEConv :255-313, the sage/rsage branches
of GraphConvLayer :526-564).

x is node-major, (N, B, C).  The per-edge transform is commuted past the
(linear) mean aggregation: aggr = lin_r(segment_mean(x_j * attr)), one SpMM
and one GEMM.  The graph is self-looped (PyG add_self_loops, fill 1.0).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.nn.basic import MLP, Linear
from multilevel_gnn_tpu_torch.ops import spmm


class RSAGEConv(nn.Module):
    """(R)SAGE conv with edge-attr-scaled messages.

    message (x_j * attr) @ W [relative: (x_j * attr - x_i) @ W], mean over
    in-edges, update MLP(cat(x, aggr)) [+ optional L2 normalize].  Mixed
    precision: the SpMM accumulates in f32 and its result is cast to the
    compute dtype (conv.py:282-283); spmm_dtype is the SpMM data type."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        act_type: str = "relu",
        normalize: bool = False,
        mlp_norm: Optional[str] = None,
        use_bias: bool = True,
        relative: bool = False,
        drop: float = 0.0,
        dtype: Optional[torch.dtype] = None,
        spmm_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.normalize = normalize
        self.relative = relative
        self.dtype = dtype
        self.spmm_dtype = spmm_dtype
        self.lin_r = Linear(
            in_channels, out_channels, use_bias=False, dtype=dtype,
            generator=generator,
        )
        self.nn = MLP(
            [in_channels + out_channels, out_channels],
            act_type=act_type, norm_type=mlp_norm, use_bias=use_bias,
            drop=drop, dtype=dtype, generator=generator,
        )

    def forward(
        self,
        x: torch.Tensor,
        graph: Graph,
        edge_attr: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        mean_j = spmm.spmm_mean(
            x, graph, edge_weight=edge_attr, dtype=self.spmm_dtype
        )
        if self.dtype is not None:
            mean_j = mean_j.to(self.dtype)
        if self.relative:
            mean_j = mean_j - x
        aggr = self.lin_r(mean_j)
        h = torch.cat([x.to(aggr.dtype), aggr], dim=-1)
        out = self.nn(h, generator)
        if self.normalize:
            o32 = out.float()
            n2 = torch.linalg.vector_norm(o32, dim=-1, keepdim=True)
            out = (o32 / torch.clamp(n2, min=1e-12)).to(out.dtype)
        return out


class GraphConvLayer(nn.Module):
    """Static graph conv dispatcher; the port has the sage and rsage convs
    (the shipped configs' gnn_name: sage)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        conv: str = "sage",
        act_type: str = "relu",
        norm: Optional[object] = None,
        use_bias: bool = True,
        mlp_norm: Optional[str] = None,
        drop: float = 0.0,
        dtype: Optional[torch.dtype] = None,
        spmm_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        c = conv.lower()
        if c not in ("sage", "rsage"):
            raise NotImplementedError(f"conv {conv} is not ported yet")
        self.gconv = RSAGEConv(
            in_channels, out_channels, act_type, bool(norm), mlp_norm,
            use_bias, c == "rsage", drop, dtype, spmm_dtype, generator,
        )

    def forward(self, x, graph, edge_attr=None, generator=None):
        return self.gconv(x, graph, edge_attr, generator)
