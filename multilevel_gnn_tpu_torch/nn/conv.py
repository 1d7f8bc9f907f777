"""The graph convolutions of the port (port of multilevel_gnn_tpu/nn/conv.py:
RSAGEConv :255-313, MRConv :444-475, EdgeConv :478-510, and the sage,
rsage, mr and edge branches of GraphConvLayer :526-595).

x is node-major, (N, B, C).  SAGE: the per-edge transform is commuted past
the (linear) mean aggregation: aggr = lin_r(segment_mean(x_j * attr)), one
SpMM and one GEMM.  MRConv and EdgeConv take a max over each node's
in-edges (K3), of x_j - x_i and of MLP(cat(x_i, x_j - x_i)).  The graph is
self-looped (PyG add_self_loops, fill 1.0).
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


def _node_rows(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """x in the compute dtype with whole node rows contiguous: the edge
    gathers copy node rows, and index_select takes its vectorized kernel
    only on a contiguous input (the first layer's input, an outer product
    with a transposed batch, is not)."""
    return (x if dtype is None else x.to(dtype)).contiguous()


class _MaxConv(nn.Module):
    """The part MRConv and EdgeConv share: an MLP [2 * in, out] named nn
    (flax's path gconv.nn.Linear_0) in the compute dtype."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        act_type: str = "relu",
        norm_type: Optional[str] = None,
        use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.nn = MLP(
            [2 * in_channels, out_channels], act_type=act_type,
            norm_type=norm_type, use_bias=use_bias, dtype=dtype,
            generator=generator,
        )


class MRConv(_MaxConv):
    """Max-relative conv: MLP(cat(x, max_j (x_j - x_i))).  The max is f32
    (K3) and is cast to the compute dtype before the concat (conv.py:467);
    the edge values x_j - x_i are taken in the compute dtype, so their
    rounding sets the ties."""

    def forward(self, x, graph: Graph, edge_attr=None, generator=None):
        x = _node_rows(x, self.dtype)
        diff = spmm.gather_src(x, graph) - spmm.gather_dst(x, graph)
        agg = spmm.edge_segment_max(
            diff, graph.receivers, graph.edge_mask, graph.csr
        )
        return self.nn(torch.cat([x, agg.to(x.dtype)], dim=-1))


class EdgeConv(_MaxConv):
    """DGCNN edge conv: max_j MLP(cat(x_i, x_j - x_i)).  The per-edge MLP
    runs in the compute dtype; the max comes back f32, as in JAX
    (conv.py:505-507), so the next layer and the value mask see f32."""

    def forward(self, x, graph: Graph, edge_attr=None, generator=None):
        x = _node_rows(x, self.dtype)
        x_i = spmm.gather_dst(x, graph)
        x_j = spmm.gather_src(x, graph)
        msg = self.nn(torch.cat([x_i, x_j - x_i], dim=-1))
        return spmm.edge_segment_max(
            msg, graph.receivers, graph.edge_mask, graph.csr
        )


class GraphConvLayer(nn.Module):
    """Static graph conv dispatcher; the port has the sage, rsage, mr and
    edge convs.  As in JAX, mr and edge take no dropout and no mlp_norm;
    their MLP norm is ``norm`` when that is a string (conv.py:584-595)."""

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
        if c in ("sage", "rsage"):
            self.gconv = RSAGEConv(
                in_channels, out_channels, act_type, bool(norm), mlp_norm,
                use_bias, c == "rsage", drop, dtype, spmm_dtype, generator,
            )
        elif c in ("mr", "edge"):
            cls = MRConv if c == "mr" else EdgeConv
            self.gconv = cls(
                in_channels, out_channels, act_type,
                norm if isinstance(norm, str) else None, use_bias, dtype,
                generator,
            )
        else:
            raise NotImplementedError(f"conv {conv} is not ported yet")

    def forward(self, x, graph, edge_attr=None, generator=None):
        return self.gconv(x, graph, edge_attr, generator)
