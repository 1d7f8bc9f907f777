"""The graph convolutions of the port (port of multilevel_gnn_tpu/nn/conv.py:
MsgNorm :39-54, GenAggregate :57-142, GENConv :145-213, PathwayConv
:216-252, RSAGEConv :255-313, GCNConv :316-350, GATConv :353-414 (its
pallas branch), GINConv :417-441, MRConv :444-475, EdgeConv :478-510,
dynamic_graph :513-523 and GraphConvLayer :526-595).

x is node-major, (N, B, C).  SAGE: the per-edge transform is commuted past
the (linear) mean aggregation: aggr = lin_r(segment_mean(x_j * attr)), one
SpMM and one GEMM.  MRConv and EdgeConv take a max over each node's
in-edges (K3), of x_j - x_i and of MLP(cat(x_i, x_j - x_i)).  The graph is
self-looped (PyG add_self_loops, fill 1.0).  GENConv's messages
relu(x_j + e) + eps go through GenAggregate: the max through K3, the sums
(sum, mean, softmax, power) through edge_segment_sum (K1), as on the JAX
package's pallas backend.  GCN and GIN sum their neighbours with the SpMM
(K2 + the K1 residual on a windowed graph, K1 otherwise), GCN with the
graph's precomputed normalisation as edge weights; GAT gathers its
per-head logits and messages to the edges and sums them with
edge_segment_sum (K1), in float32.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.nn.basic import (
    MLP,
    Linear,
    Norm,
    act,
    in_dtype,
    leaky_relu,
    uniform_,
    xavier_bound,
)
from multilevel_gnn_tpu_torch.ops import spmm
from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import CSRPlan

SOFTMAX_AGGRS = ("softmax", "softmax_sg", "softmax_sum")
POWER_AGGRS = ("power", "power_sum")


class _Sqrt(torch.autograd.Function):
    """torch.sqrt with JAX's backward, g * (0.5 / sqrt(a)): in bf16 the
    quotient and the product each round, where torch's g / (2 sqrt(a))
    rounds once."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a):
        return torch.sqrt(a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return g * (0.5 / out)


class MsgNorm(nn.Module):
    """MsgNorm (conv.py:39-54): msg / max(||msg||, 1e-12) * ||x|| * s over
    the last axis, s the learned msg_scale or 1.  The norm of a bf16 x
    squares in bf16, sums in float32, rounds the sum to bf16 and takes a
    bf16 square root, as JAX's op-by-op run of jnp.linalg.norm does; under
    jit XLA keeps it in float32 (ROADMAP section 3, R1)."""

    def __init__(self, learn_msg_scale: bool = False):
        super().__init__()
        self.msg_scale = nn.Parameter(torch.ones(1)) if learn_msg_scale else None

    @staticmethod
    def _norm(v: torch.Tensor) -> torch.Tensor:
        sq = (v * v).float().sum(-1, keepdim=True)
        return _Sqrt.apply(sq.to(v.dtype))

    def forward(self, x: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
        msg = msg / torch.clamp(self._norm(msg), min=1e-12)
        out = msg * self._norm(x)
        return out * self.msg_scale if self.msg_scale is not None else out


class GenAggregate(nn.Module):
    """GENConv's generalised aggregation (conv.py:57-142) of (E, B, C)
    edge-major messages into (N, B, C) float32 node rows: add / sum, mean,
    max; softmax, softmax_sg, softmax_sum (temperature t, learned with
    learn_t for softmax and softmax_sum, degree-scaled by in_degree **
    sigmoid(y) for softmax_sum); power, power_sum (power p, learned with
    learn_p; in float32 with JAX's clamps).  y is a parameter of the _sum
    aggregators, frozen unless learn_y.  Softmax weights are float32, with
    the global-max shift of segment_softmax_weights; with t not learned
    they are computed without gradient, as the reference computes them."""

    def __init__(self, aggr: str = "softmax", t: float = 1.0, learn_t: bool = False,
                 p: float = 1.0, learn_p: bool = False, y: float = 0.0,
                 learn_y: bool = False):
        super().__init__()
        if aggr not in ("add", "sum", "mean", "max") + SOFTMAX_AGGRS + POWER_AGGRS:
            raise NotImplementedError(aggr)
        self.aggr, self.t_value, self.p_value, self.learn_y = aggr, t, p, learn_y
        self.t = (nn.Parameter(torch.full((1,), float(t)))
                  if learn_t and aggr in ("softmax", "softmax_sum") else None)
        self.p = (nn.Parameter(torch.full((1,), float(p)))
                  if learn_p and aggr in POWER_AGGRS else None)
        self.y = (nn.Parameter(torch.full((1,), float(y)))
                  if aggr in ("softmax_sum", "power_sum") else None)

    def _degree_scale(self, out, graph: Graph):
        y = self.y if self.learn_y else self.y.detach()
        deg = graph.in_degree().reshape((-1,) + (1,) * (out.dim() - 1))
        return torch.pow(deg, torch.sigmoid(y)) * out

    def forward(self, msg: torch.Tensor, graph: Graph) -> torch.Tensor:
        a = self.aggr
        if a in ("add", "sum"):
            return spmm.edge_segment_sum(msg, graph)
        if a == "mean":
            return spmm.edge_segment_mean(msg, graph)
        if a == "max":
            return spmm.graph_segment_max(msg, graph)
        if a in SOFTMAX_AGGRS:
            if self.t is not None:
                w = spmm.segment_softmax_weights((msg * self.t).float(), graph)
            else:
                with torch.no_grad():
                    z = msg * in_dtype(self.t_value, msg.dtype)
                    w = spmm.segment_softmax_weights(z.float(), graph)
            out = spmm.edge_segment_sum(msg * w.to(msg.dtype), graph)
            return self._degree_scale(out, graph) if a == "softmax_sum" else out
        min_v, max_v = 1e-7, 1e1
        p = self.p if self.p is not None else self.p_value
        m = torch.clamp(msg.float(), min_v, max_v)
        out = torch.clamp(spmm.edge_segment_mean(torch.pow(m, p), graph), min_v, max_v)
        out = torch.pow(out, 1.0 / p)
        return self._degree_scale(out, graph) if a == "power_sum" else out


class GENConv(nn.Module):
    """GENeralized Graph Convolution (conv.py:145-213) on node-major x
    (N, B, C): msg = relu(x_j + e) + eps in the compute dtype, with e the
    (E, C) edge features broadcast over B (through the conv's own Linear
    edge_encoder when encode_edge); m = GenAggregate(msg) (float32);
    optional MsgNorm; h = x + m cast to x's dtype; then the feature
    encoder: an MLP [in, 2 in, ..., emb] with norm_type after every Linear
    but the last (gnn_encoder 'linear'), or a Linear + relu ('conv1x1').
    pca_only skips the message passing and encodes x alone."""

    def __init__(
        self,
        in_dim: int,
        emb_dim: int,
        aggr: str = "softmax",
        t: float = 1.0,
        learn_t: bool = False,
        p: float = 1.0,
        learn_p: bool = False,
        y: float = 0.0,
        learn_y: bool = False,
        msg_norm: bool = False,
        learn_msg_scale: bool = True,
        encode_edge: bool = False,
        edge_feat_dim: Optional[int] = None,
        norm_type: str = "batch",
        mlp_layers: int = 2,
        eps: float = 1e-7,
        pca_only: bool = False,
        gnn_encoder: str = "linear",
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype, self.eps, self.pca_only = dtype, eps, pca_only
        self.conv1x1 = gnn_encoder == "conv1x1"
        if self.conv1x1:
            self.feature_encoder = Linear(in_dim, emb_dim, dtype=dtype, generator=generator)
        else:
            chans = [in_dim] + [in_dim * 2] * (mlp_layers - 1) + [emb_dim]
            self.feature_encoder = MLP(chans, norm_type=norm_type, last_lin=True,
                                       dtype=dtype, generator=generator)
        if pca_only:
            return
        self.edge_encoder = (
            Linear(edge_feat_dim, in_dim, dtype=dtype, generator=generator)
            if encode_edge else None)
        self.aggregate = GenAggregate(aggr, t, learn_t, p, learn_p, y, learn_y)
        self.msg_norm = MsgNorm(learn_msg_scale) if msg_norm else None

    def _encode(self, h, generator):
        if self.conv1x1:
            return torch.relu(self.feature_encoder(h))
        return self.feature_encoder(h, generator)

    def forward(self, x, graph: Graph, edge_attr=None, generator=None):
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.pca_only:
            return self._encode(x, generator)
        if x.shape[0] != graph.n_nodes:
            # JAX gathers clamped rows and fails at h = x + m (conv.py:212)
            raise TypeError(f"add got incompatible shapes for broadcasting: x has "
                            f"{x.shape[0]} node rows, the aggregate {graph.n_nodes}")
        e = edge_attr
        if self.edge_encoder is not None and edge_attr is not None:
            e = self.edge_encoder(edge_attr)
        msg = spmm.gather_src(x.contiguous(), graph)
        if e is not None:
            if e.dim() == 2 and msg.dim() == 3:
                e = e[:, None, :]  # (E, C) over the batch axis
            msg = msg + e.to(msg.dtype)
        msg = torch.relu(msg) + in_dtype(self.eps, msg.dtype)
        m = self.aggregate(msg, graph)
        if self.msg_norm is not None:
            m = self.msg_norm(x, m)
        return self._encode(x + m.to(x.dtype), generator)


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
            drop=drop, dtype=dtype, generator=generator, batch_axis=1,
        )

    def forward(
        self,
        x: torch.Tensor,
        graph: Graph,
        edge_attr: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        # an f32 x (the trunk's input) is cast for each use on its own, so
        # the two cotangents, each rounded to the compute dtype, are added
        # in f32, as XLA keeps that sum (it drops the bf16 round trip)
        xd = x if self.dtype is None else x.to(self.dtype)
        mean_j = spmm.spmm_mean(
            xd, graph, edge_weight=edge_attr, dtype=self.spmm_dtype
        )
        if self.dtype is not None:
            mean_j = mean_j.to(self.dtype)
        if self.relative:
            mean_j = mean_j - xd
        aggr = self.lin_r(mean_j)
        h = torch.cat([x.to(aggr.dtype), aggr], dim=-1)
        out = self.nn(h, generator)
        if self.normalize:
            o32 = out.float()
            n2 = torch.linalg.vector_norm(o32, dim=-1, keepdim=True)
            out = (o32 / torch.clamp(n2, min=1e-12)).to(out.dtype)
        return out


class GCNConv(nn.Module):
    """Kipf-Welling GCN over A + I with symmetric normalisation:
    lin(x) summed over the in-edges with weights dinv[s] * dinv[r]
    (graph.gcn_coef), plus lin(x) * dinv ** 2 (graph.gcn_self), plus bias,
    act, then Norm when norm_type.  As in JAX, the graph the model hands it
    is self-looped, so a node's own row enters twice (ROADMAP section 3).
    Under a bf16 compute dtype the product and the SpMM's sum are bf16 and
    the float32 bias promotes the rest to float32 (conv.py:331-349)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        act_type: Optional[str] = "relu",
        norm_type: Optional[str] = None,
        use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
        spmm_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.act_type, self.spmm_dtype = act_type, spmm_dtype
        self.lin = Linear(in_channels, out_channels, use_bias=False, kernel_init="xavier",
                          dtype=dtype, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None
        self.Norm_0 = Norm(norm_type, out_channels) if norm_type else None

    def forward(self, x, graph: Graph, edge_attr=None, generator=None):
        xw = self.lin(x)
        agg = spmm.spmm_sum(xw, graph, edge_weight=graph.gcn_coef,
                            dtype=self.spmm_dtype).to(xw.dtype)
        dinv2 = graph.gcn_self.reshape((-1,) + (1,) * (xw.dim() - 1))
        agg = agg + xw * dinv2.to(xw.dtype)
        if self.bias is not None:
            agg = agg + self.bias
        out = act(agg, self.act_type)
        return self.Norm_0(out) if self.Norm_0 is not None else out


class GATConv(nn.Module):
    """Multi-head graph attention (PyG GATConv semantics) in float32, as
    JAX keeps it (flax's Dense promotes a bf16 x): xw = lin(x) per head,
    edge logits leaky_relu(a_src[s] + a_dst[r]) softmaxed over each
    receiver's in-edges (segment_softmax_weights, the column-max shift of
    JAX's pallas branch), messages xw[s] * alpha summed per receiver
    (edge_segment_sum, K1), then bias, act, Norm.  The node -> edge
    gathers take K1 as their backward, as JAX's gather_rows does."""

    def __init__(
        self,
        in_channels: int,
        out_per_head: int,
        heads: int = 8,
        act_type: Optional[str] = "relu",
        norm_type: Optional[str] = None,
        use_bias: bool = True,
        negative_slope: float = 0.2,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        H, D = heads, out_per_head
        self.heads, self.out_per_head = H, D
        self.act_type, self.negative_slope = act_type, negative_slope
        self.lin = Linear(in_channels, H * D, use_bias=False, kernel_init="xavier",
                          generator=generator)
        # flax's glorot_uniform on (1, H, D): fan_in H, fan_out D
        self.att_src = nn.Parameter(torch.empty(1, H, D))
        self.att_dst = nn.Parameter(torch.empty(1, H, D))
        for p in (self.att_src, self.att_dst):
            uniform_(p, xavier_bound(H, D), generator)
        self.bias = nn.Parameter(torch.zeros(H * D)) if use_bias else None
        self.Norm_0 = Norm(norm_type, H * D) if norm_type else None

    def forward(self, x, graph: Graph, edge_attr=None, generator=None):
        H, D = self.heads, self.out_per_head
        xw = self.lin(x.float())  # (N, B, H*D)
        xh = xw.reshape(xw.shape[:-1] + (H, D))
        a_src = (xh * self.att_src).sum(-1)  # (N, B, H)
        a_dst = (xh * self.att_dst).sum(-1)
        alpha = spmm.gather_src(a_src, graph) + spmm.gather_dst(a_dst, graph)
        alpha = leaky_relu(alpha, self.negative_slope)
        alpha = spmm.segment_softmax_weights(alpha, graph)  # (E, B, H)
        msg = spmm.gather_src(xw, graph)
        msg = (msg.reshape(msg.shape[:-1] + (H, D)) * alpha[..., None]).reshape(msg.shape)
        out = spmm.edge_segment_sum(msg, graph)
        if self.bias is not None:
            out = out + self.bias
        out = act(out, self.act_type)
        return self.Norm_0(out) if self.Norm_0 is not None else out


class GINConv(nn.Module):
    """GIN: MLP((1 + eps) x + sum_j x_j), the unweighted sum through the
    SpMM, in the compute dtype ((1 + eps) is a weak Python float, so a
    bf16 x stays bf16, conv.py:437-438)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        act_type: str = "relu",
        norm_type: Optional[str] = None,
        use_bias: bool = True,
        eps: float = 0.0,
        dtype: Optional[torch.dtype] = None,
        spmm_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.eps, self.dtype, self.spmm_dtype = eps, dtype, spmm_dtype
        self.nn = MLP([in_channels, out_channels], act_type=act_type, norm_type=norm_type,
                      use_bias=use_bias, dtype=dtype, generator=generator)

    def forward(self, x, graph: Graph, edge_attr=None, generator=None):
        # each use of an f32 x casts it on its own, as in RSAGEConv.forward
        dt = x.dtype if self.dtype is None else self.dtype
        agg = spmm.spmm_sum(x.to(dt), graph, dtype=self.spmm_dtype).to(dt)
        h = x.to(dt) * in_dtype(1.0 + self.eps, dt) + agg
        return self.nn(h, generator)


class PathwayConv(nn.Module):
    """Outer-product-message conv (conv.py:216-252) on node-major x
    (N, B, C), float32: each message is x_j outer the edge's raw (E, A)
    attrs, flattened to C * A and taken through msg_encoder, a Linear
    (C * A -> C) (x_j alone without attrs, and then no msg_encoder, as
    flax creates none); m = GenAggregate(msg) (K3 for max, K1 for the
    sums); out = relu(MLP(x + m)) with an MLP [C, 2 C, ..., emb] (norm
    after every Linear but the last), times the (N, 1) mask."""

    def __init__(
        self,
        in_dim: int,
        emb_dim: int,
        edge_feat_dim: Optional[int] = 2,
        aggr: str = "softmax",
        t: float = 1.0,
        learn_t: bool = False,
        norm_type: str = "batch",
        mlp_layers: int = 2,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.msg_encoder = (Linear(in_dim * edge_feat_dim, in_dim, generator=generator)
                            if edge_feat_dim is not None else None)
        self.aggregate = GenAggregate(aggr, t, learn_t)
        chans = [in_dim] + [in_dim * 2] * (mlp_layers - 1) + [emb_dim]
        self.mlp = MLP(chans, norm_type=norm_type, last_lin=True, generator=generator)

    def forward(self, x, graph: Graph, edge_attr=None, mask=None, generator=None):
        msg = spmm.gather_src(x.contiguous(), graph)
        if edge_attr is not None:
            if self.msg_encoder is None:
                raise ValueError("this PathwayConv was built without edge attrs")
            shape = (-1,) + (1,) * (msg.dim() - 2) + (1, edge_attr.shape[-1])
            outer = msg[..., :, None] * edge_attr.reshape(shape)
            msg = self.msg_encoder(outer.flatten(-2))
        m = self.aggregate(msg, graph)
        out = torch.relu(self.mlp(x + m, generator))
        if mask is not None:
            out = out * mask.reshape((-1,) + (1,) * (out.dim() - 1))
        return out


def _node_rows(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """x in the compute dtype with whole node rows contiguous: the edge
    gathers copy node rows, and index_select takes its vectorized kernel
    only on a contiguous input (the first layer's input, an outer product
    with a transposed batch, is not).  EdgeConv calls it for each use of x,
    so an f32 x (the trunk's input) gets its two cotangents added in f32,
    as XLA adds them (see RSAGEConv.forward); MRConv casts once, which
    comes closer to XLA's sum of its three (ROADMAP section 3, F3)."""
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
        agg = spmm.graph_segment_max(diff, graph)
        return self.nn(torch.cat([x, agg.to(x.dtype)], dim=-1))


class EdgeConv(_MaxConv):
    """DGCNN edge conv: max_j MLP(cat(x_i, x_j - x_i)).  The per-edge MLP
    runs in the compute dtype; the max comes back f32, as in JAX
    (conv.py:505-507), so the next layer and the value mask see f32."""

    def forward(self, x, graph: Graph, edge_attr=None, generator=None):
        x_i = spmm.gather_dst(_node_rows(x, self.dtype), graph)
        x_j = spmm.gather_src(_node_rows(x, self.dtype), graph)
        msg = self.nn(torch.cat([x_i, x_j - x_i], dim=-1))
        return spmm.graph_segment_max(msg, graph)


def dynamic_graph(senders: torch.Tensor, receivers: torch.Tensor, n_nodes: int) -> Graph:
    """A Graph of edges made on the device (conv.py:513-523), such as
    ops.knn.knn_graph's, with every plan the convs read built there from
    the tensors and their shapes, without a copy to the host: receivers
    must be sorted (knn_graph's are), so csr and dst_gather need no sort;
    csc and src_gather come from a stable sort of the senders.  Every edge
    is real; the JAX package runs such a graph on XLA, the port on K1 and
    K3."""
    dev = senders.device
    s, r = senders.long(), receivers.long()
    E = int(s.shape[0])
    eid = torch.arange(E, device=dev)
    order = torch.argsort(s, stable=True)
    s_sorted, r_by_s = s.index_select(0, order), r.index_select(0, order)
    csr = CSRPlan.on_device(r, s, eid, n_nodes, n_nodes - 1)
    deg = (csr.rowptr[1:] - csr.rowptr[:-1]).float()
    dinv = torch.rsqrt(deg + 1.0)
    return Graph(
        senders=s, receivers=r, edge_attr=None,
        edge_mask=torch.ones(E, dtype=torch.bool, device=dev),
        n_nodes=int(n_nodes), n_edges=E, csr=csr,
        csc=CSRPlan.on_device(s_sorted, r_by_s, order, n_nodes, n_nodes - 1),
        src_gather=CSRPlan.on_device(s_sorted, order, order, n_nodes, E - 1),
        dst_gather=CSRPlan.on_device(r, eid, eid, n_nodes, E - 1),
        in_deg=deg,
        gcn_coef=dinv.index_select(0, s) * dinv.index_select(0, r),
        gcn_self=dinv * dinv,
    )


class GraphConvLayer(nn.Module):
    """Static graph conv dispatcher (conv.py:526-595) for sage, rsage, gcn,
    gat, gin, mr and edge.  As in JAX: only sage / rsage take dropout and
    mlp_norm and read ``norm`` as the L2-normalise flag; the others take
    ``norm`` as their Norm (gcn, gat) or MLP norm (gin, mr, edge) when it
    is a string; GAT splits out_channels over ``heads`` (out_channels //
    heads each) and runs in float32.  out_width is the width it returns."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        conv: str = "sage",
        act_type: str = "relu",
        norm: Optional[object] = None,
        use_bias: bool = True,
        heads: int = 8,
        mlp_norm: Optional[str] = None,
        drop: float = 0.0,
        dtype: Optional[torch.dtype] = None,
        spmm_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        c = conv.lower()
        norm_str = norm if isinstance(norm, str) else None
        self.out_width = out_channels
        if c in ("sage", "rsage"):
            self.gconv = RSAGEConv(
                in_channels, out_channels, act_type, bool(norm), mlp_norm,
                use_bias, c == "rsage", drop, dtype, spmm_dtype, generator,
            )
        elif c == "gcn":
            self.gconv = GCNConv(in_channels, out_channels, act_type, norm_str, use_bias,
                                 dtype, spmm_dtype, generator)
        elif c == "gat":
            self.gconv = GATConv(in_channels, out_channels // heads, heads, act_type,
                                 norm_str, use_bias, generator=generator)
            self.out_width = (out_channels // heads) * heads
        elif c == "gin":
            self.gconv = GINConv(in_channels, out_channels, act_type, norm_str, use_bias,
                                 dtype=dtype, spmm_dtype=spmm_dtype, generator=generator)
        elif c in ("mr", "edge"):
            cls = MRConv if c == "mr" else EdgeConv
            self.gconv = cls(in_channels, out_channels, act_type, norm_str, use_bias, dtype,
                             generator)
        else:
            raise NotImplementedError(f"conv {conv} is not implemented")

    def forward(self, x, graph, edge_attr=None, generator=None):
        return self.gconv(x, graph, edge_attr, generator)
