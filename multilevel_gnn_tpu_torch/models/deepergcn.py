"""DeeperGCN, a GENConv residual stack over the gene-level graph with
pathway nodes (port of multilevel_gnn_tpu/models/deepergcn.py:
TransformerEncoderLayer :38-65, apply_init_weight :68-101, DeeperGCN
:104-323).

  node encoder Linear(omics [+ node embedding]) -> pathway-node rows
  replaced by Linear(pathway PCA attrs) -> GENConv blocks (res+ / res /
  plain, with the inter-layer norms and dropouts) -> pathway readout
  (mean, MSA transformer, or maxpool-4 + Linear) -> age -> head MLP ->
  softmax.

The trunk is node-major, (N, B, H): messages are (E, B, H), so K3 (the
max aggregation) and K1 (the sum aggregations, the gather backwards and
the edge-id lookup's backward) see F = B * H features a row.  The encoders,
the readout and the head run in float32, the GENConv stack in
cfg.compute_dtype.  Parameter names follow the flax module paths
(gcn_0.feature_encoder.Linear_0, norm_0, readout_msa, head_out, ...) for
interop.py.  The model returns (probabilities, None): no feature losses
apply (JAX train/step.py:186-205).

pca_only runs as JAX runs it: its GENConvs get the P pathway rows over
the N-node graph and raise (DeeperGCN._encode_pca_only).

Kept from the JAX package: every pathway row takes node-embedding row 0
(:138-147) before the pathway rows are replaced; the MSA readout
normalises the pathway axis with the current batch's statistics, padded
rows included, in eval too (:270-279); the maxpool readout trims P to a
multiple of 4 (:283-287).  The edge-id table is looked up rather than
multiplied by an (E, V) one-hot, with a deterministic K1 backward
(DeeperGCN._edge_features).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from multilevel_gnn_tpu_torch.core.batch import Batch, FoldContext
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.core.device import resolve_device
from multilevel_gnn_tpu_torch.nn.basic import (
    Dropout,
    EmbedTable,
    Linear,
    Norm,
    apply_dropout,
    uniform_,
    xavier_bound,
)
from multilevel_gnn_tpu_torch.models.multilevel_gnn import compute_dtype
from multilevel_gnn_tpu_torch.nn.conv import GENConv
from multilevel_gnn_tpu_torch.ops.spmm import gather_rows
from multilevel_gnn_tpu_torch.parallel.comm import batch_moments


class _Projection(nn.Module):
    """One of flax's DenseGeneral projections of the attention, in flax's
    layout: weight (d, heads, head_dim) with bias (heads, head_dim) for
    query / key / value, weight (heads, head_dim, d) with bias (d,) for
    out.  Not a Linear, so apply_init_weight leaves it alone, as JAX's
    skips these 3-D kernels."""

    def __init__(self, weight_shape, bias_shape, generator):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(weight_shape))
        # glorot over the flattened (in, out) kernel, as DenseGeneral draws it
        d = weight_shape[0] if len(bias_shape) == 2 else weight_shape[-1]
        uniform_(self.weight, xavier_bound(d, d), generator)
        self.bias = nn.Parameter(torch.zeros(bias_shape))


class MultiHeadAttention(nn.Module):
    """flax MultiHeadDotProductAttention(num_heads, qkv_features=d) on
    (B, P, d) float32 self-attention, written as products and a softmax:
    q / sqrt(head_dim), softmax over the keys, a dropout mask broadcast
    over the batch and the heads (flax's broadcast_dropout), the out
    projection over (heads, head_dim)."""

    def __init__(self, d: int, heads: int, dropout: float, generator):
        super().__init__()
        hd = d // heads
        self.heads, self.head_dim, self.rate = heads, hd, float(dropout)
        for name in ("query", "key", "value"):
            self.add_module(name, _Projection((d, heads, hd), (heads, hd), generator))
        self.out = _Projection((heads, hd, d), (d,), generator)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        def proj(m):
            return torch.einsum("bpd,dhk->bphk", x, m.weight) + m.bias

        q, k, v = proj(self.query), proj(self.key), proj(self.value)
        q = q / math.sqrt(self.head_dim)
        w = torch.softmax(torch.einsum("bqhk,bshk->bhqs", q, k), dim=-1)
        if self.training and self.rate > 0.0:
            if generator is None:
                raise ValueError("training-mode dropout needs a torch.Generator")
            w = apply_dropout(w, generator, 1.0 - self.rate, (1, 1) + tuple(w.shape[-2:]))
        o = torch.einsum("bhqs,bshk->bqhk", w, v)
        return torch.einsum("bqhk,hkd->bqd", o, self.out.weight) + self.out.bias


class TransformerEncoderLayer(nn.Module):
    """torch.nn.TransformerEncoderLayer's post-norm form as the JAX package
    writes it (deepergcn.py:38-65): x = LN(x + drop(MHA(x))), x = LN(x +
    drop(FFN(x))), FFN = Linear(2048) relu drop Linear(d), float32."""

    def __init__(self, d_model: int, nhead: int = 8, dim_feedforward: int = 2048,
                 dropout: float = 0.1, generator=None):
        super().__init__()
        self.MultiHeadDotProductAttention_0 = MultiHeadAttention(
            d_model, nhead, dropout, generator)
        self.LayerNorm_0 = Norm("layer", d_model)
        self.Linear_0 = Linear(d_model, dim_feedforward, kernel_init="xavier",
                               generator=generator)
        self.Linear_1 = Linear(dim_feedforward, d_model, kernel_init="xavier",
                               generator=generator)
        self.LayerNorm_1 = Norm("layer", d_model)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        a = self.MultiHeadDotProductAttention_0(x, generator)
        x = self.LayerNorm_0(x + self.drop(a, generator))
        ff = self.drop(torch.relu(self.Linear_0(x)), generator)
        ff = self.Linear_1(ff)
        return self.LayerNorm_1(x + self.drop(ff, generator))


def check_supported(cfg: Config) -> None:
    if cfg.block not in ("res+", "res", "plain"):
        raise NotImplementedError(f"DeeperGCN block {cfg.block!r}")
    if cfg.pathway_global_node and cfg.pathway_readout not in (None, "MSA", "maxpool"):
        raise NotImplementedError(f"pathway_readout {cfg.pathway_readout!r}")


class DeeperGCN(nn.Module):
    """DeeperGCN for one cohort's shapes, read from cfg: node_num (genes +
    pathway nodes), pathway_num, pathway_edge_num (the edge-id table's
    rows), pca_dim.  forward(batch, ctx) takes batch.x (B, N, omics) with
    zero pathway rows and batch.raw_data (B, P, 3 * pca_dim) pathway node
    attrs; the edge ids and their lookup plan ride ctx (edge_ids,
    edge_id_gather).  Parameters are drawn from ``generator`` (a CPU
    torch.Generator; seeded from ``seed`` when None) and moved to
    ``device``; the driver then applies apply_init_weight when
    cfg.all_init or cfg.head_init, as JAX's driver does."""

    def __init__(self, cfg: Config, device="cuda", generator: Optional[torch.Generator] = None,
                 seed: int = 0):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(seed)
        self.cfg = cfg
        cdt = compute_dtype(cfg)
        H = cfg.hidden_channels
        P = cfg.pathway_num if cfg.pathway_global_node else 0
        self.P = P
        n_feat = 5 if cfg.mul_attr else 3
        if cfg.node_embedding:
            D = cfg.node_embedding_dim
            self.node_embedding_encoder = EmbedTable(cfg.node_num, D)
            t = self.node_embedding_encoder.embedding
            if cfg.init_emb:
                uniform_(t, xavier_bound(cfg.node_num, D), g)
            else:
                with torch.no_grad():
                    t.normal_(0.0, 1.0, generator=g)
            n_feat += D
        else:
            self.node_embedding_encoder = None
        self.node_features_encoder = Linear(n_feat, H, kernel_init="xavier", generator=g)
        self.vocab = max(cfg.pathway_edge_num, 1)
        self.onehot_edges = cfg.use_edge_attr and cfg.global_edge == "onehot"
        if self.onehot_edges:
            self.edge_encoder = EmbedTable(self.vocab, H)
            uniform_(self.edge_encoder.embedding, xavier_bound(self.vocab, H), g)
        elif cfg.use_edge_attr:
            self.edge_encoder = Linear(1, H, kernel_init="xavier", generator=g)
        else:
            self.edge_encoder = None
        if cfg.pathway_global_node:
            self.pathway_features_encoder = Linear(3 * cfg.pca_dim, H, kernel_init="xavier",
                                                   generator=g)
        for i in range(cfg.num_layers):
            self.add_module(f"gcn_{i}", GENConv(
                H, H, aggr=cfg.gcn_aggr, t=cfg.t, learn_t=cfg.learn_t, p=cfg.p,
                learn_p=cfg.learn_p, msg_norm=cfg.msg_norm,
                learn_msg_scale=cfg.learn_msg_scale,
                encode_edge=cfg.conv_encode_edge and cfg.use_edge_attr,
                edge_feat_dim=H, norm_type=cfg.norm, mlp_layers=cfg.mlp_layers,
                dtype=cdt, generator=g))
        for i in range(cfg.num_layers):
            self.add_module(f"norm_{i}", Norm(cfg.norm, H, dtype=cdt))
        self.drop = Dropout(cfg.dropout, batch_axis=1)  # (N, B, H)
        head_in = H
        if cfg.pathway_global_node and cfg.pathway_readout == "MSA":
            self.pred_norm_scale = nn.Parameter(torch.ones(P))
            self.pred_norm_bias = nn.Parameter(torch.zeros(P))
            self.readout_msa = TransformerEncoderLayer(H, generator=g)
        elif cfg.pathway_global_node and cfg.pathway_readout == "maxpool":
            self.feature_drop = Dropout(0.25 if cfg.feature_drop else 0.0)
            self.readout = Linear(H * (P // 4) + (1 if cfg.pre_concat_age else 0), H,
                                  kernel_init="xavier", generator=g)
            self.readout_drop = Dropout(0.0 if cfg.pre_readout_drop else 0.5)
        if cfg.use_age and not cfg.pre_concat_age:
            head_in += 1
        for i in range(cfg.num_layer_head - 1):
            self.add_module(f"head_{i}", Linear(head_in, head_in, kernel_init="xavier",
                                                generator=g))
        self.head_drop = Dropout(cfg.dropout if cfg.head_dropout else 0.0)
        self.head_out = Linear(head_in, cfg.num_tasks, kernel_init="xavier", generator=g)
        self.to(dev)

    def _edge_features(self, ctx: FoldContext):
        graph = ctx.graph
        if self.edge_encoder is None:
            return None
        if graph.edge_attr is None:
            raise ValueError("use_edge_attr needs a graph with edge attrs")
        if not self.onehot_edges:
            return self.edge_encoder(graph.edge_attr[:, :1])
        plan = ctx.edge_id_gather
        # V table rows a unit (U * V in a plan stacked over U units)
        if plan is None or plan.n_rows != self.vocab * plan.units:
            raise ValueError(
                f"the fold context needs edge ids over {self.vocab} table rows "
                "(make_fold_context(edge_vocab=...))")
        # onehot_embed (basic.py:161-169) as a lookup: no (E, V) one-hot;
        # the table's gradient is K1 over plan (CSRPlan.gather(ids, V)),
        # each row's cotangents summed in a fixed order, deterministic like
        # the one-hot product's transpose (index_add_ adds with atomics on
        # CUDA)
        return gather_rows(self.edge_encoder.embedding, ctx.edge_ids, plan)

    def encode(self, batch: Batch, ctx: FoldContext) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(h (N, B, H) in the compute dtype, edge features (E, H) or None)
        ahead of the GENConv stack."""
        cfg, P = self.cfg, self.P
        B, N, _ = batch.x.shape  # a (B, NODES) x raises here, as in JAX (:120)
        if cfg.pca_only:
            return self._encode_pca_only(batch), None
        x = batch.x.transpose(0, 1)  # (N, B, omics)
        if self.node_embedding_encoder is not None:
            table = self.node_embedding_encoder.embedding
            # pathway rows take embedding row 0 (the reference's quirk)
            emb = torch.cat([table[: N - P], table[:1].expand(P, -1)])
            x = torch.cat([x, emb[:, None, :].expand(N, B, emb.shape[1])], dim=-1)
        h = self.node_features_encoder(x)
        e = self._edge_features(ctx)
        if cfg.pathway_global_node and batch.raw_data is not None:
            p_emb = self.pathway_features_encoder(batch.raw_data.transpose(0, 1))
            h = torch.cat([h[: N - P], p_emb])
        cdt = compute_dtype(cfg)
        if cdt is not None:
            h = h.to(cdt)
            e = e.to(cdt) if e is not None else None
        return h, e

    def _encode_pca_only(self, batch: Batch):
        """pca_only (deepergcn.py:125-190): relu of the encoded pathway
        attrs, (P, B, H), or None without them.  The GENConvs, which are
        not told pca_only, then meet P rows over the N-node graph and
        raise TypeError at x + m (GENConv.forward); with h None they
        raise AttributeError, as JAX's pallas backend does."""
        if not (self.cfg.pathway_global_node and batch.raw_data is not None):
            return None
        h = torch.relu(self.pathway_features_encoder(batch.raw_data.transpose(0, 1)))
        cdt = compute_dtype(self.cfg)
        return h.to(cdt) if cdt is not None else h

    def stack(self, h, graph, e, generator=None):
        """The GENConv blocks (deepergcn.py:226-263); returns float32."""
        cfg, L = self.cfg, self.cfg.num_layers
        gcn = [getattr(self, f"gcn_{i}") for i in range(L)]
        norm = [getattr(self, f"norm_{i}") for i in range(L)]

        def drop(v):
            return self.drop(v, generator)

        if cfg.block == "res+":
            h = gcn[0](h, graph, e, generator)
            for i in range(1, L):
                h1 = norm[i - 1](h) if not cfg.no_inter_norm else h
                h2 = torch.relu(h1)
                if not cfg.no_inter_drop:
                    h2 = drop(h2)
                h = gcn[i](h2, graph, e, generator) + h
            h = norm[L - 1](h)
            if not cfg.no_inter_drop:
                h = drop(h)
        elif cfg.block == "res":
            h = drop(torch.relu(norm[0](gcn[0](h, graph, e, generator))))
            for i in range(1, L):
                h1 = gcn[i](h, graph, e, generator)
                h = drop(torch.relu(norm[i](h1)) + h)
        else:  # plain
            h = drop(torch.relu(norm[0](gcn[0](h, graph, e, generator))))
            for i in range(1, L):
                h1 = gcn[i](h, graph, e, generator)
                h2 = norm[i](h1) if not cfg.no_inter_norm else h1
                h = torch.relu(h2) if i != L - 1 else h2
                if not cfg.no_inter_drop:
                    h = drop(h)
        return h.float()

    def readout_head(self, h, batch: Batch, generator=None, data=None) -> torch.Tensor:
        """Pathway readout (or graph pooling), age and head (:266-323) on
        the stack's float32 (N, B, H); returns the probabilities.  data:
        the fold context's DataShard on a data rank of a mesh, whose MSA
        statistics then take the whole batch."""
        cfg, P = self.cfg, self.P
        age = batch.age[:, None].float()
        if cfg.pathway_global_node:
            pw = h[h.shape[0] - P:].transpose(0, 1)  # (B, P, H)
            if cfg.pathway_readout is None:
                hg = pw.mean(1)
            elif cfg.pathway_readout == "MSA":
                # batch statistics per pathway over (B, H), padded rows in
                m, v = batch_moments(pw, (0, 2), data)
                pwn = (pw - m) * torch.rsqrt(v + 1e-5)
                pwn = pwn * self.pred_norm_scale[None, :, None] + self.pred_norm_bias[None, :, None]
                hg = self.readout_msa(pwn, generator).mean(1)
            else:  # maxpool
                pw = self.feature_drop(pw, generator)
                Bn, _, H = pw.shape
                t = pw.transpose(1, 2)[:, :, : (P // 4) * 4]
                hg = t.reshape(Bn, H, P // 4, 4).amax(-1).reshape(Bn, -1)
                if cfg.pre_concat_age:
                    hg = torch.cat([hg, age], dim=-1)
                hg = self.readout_drop(torch.relu(self.readout(hg)), generator)
        elif cfg.graph_pooling == "sum":
            hg = h.sum(0)
        elif cfg.graph_pooling == "max":
            hg = h.amax(0)
        else:
            hg = h.mean(0)
        if cfg.use_age and not cfg.pre_concat_age:
            hg = torch.cat([hg, age], dim=-1)
        for i in range(cfg.num_layer_head - 1):
            hg = self.head_drop(torch.relu(getattr(self, f"head_{i}")(hg)), generator)
        return torch.softmax(self.head_out(hg), dim=-1)

    def forward(self, batch: Batch, ctx: FoldContext,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, None]:
        """Returns (softmax probabilities (B, num_tasks), None); generator:
        the dropout masks' source in training mode."""
        h, e = self.encode(batch, ctx)
        h = self.stack(h, ctx.graph, e, generator)
        return self.readout_head(h, batch, generator, ctx.data), None


@torch.no_grad()
def apply_init_weight(model: nn.Module, generator: torch.Generator,
                      head_only: bool = False) -> None:
    """The reference's DeeperGCN re-init (deepergcn.py:68-101), in place:
    Xavier-uniform on every Linear weight and a zero bias; head_only: only
    the Linears whose path has a part starting with "head".  The
    attention projections are not Linears, as JAX skips their 3-D kernels;
    the random stream is not JAX's, so only the distribution matches."""
    for name, m in model.named_modules():
        if not isinstance(m, Linear):
            continue
        if head_only and not any(s.startswith("head") for s in name.split(".")):
            continue
        out_f, in_f = m.weight.shape
        w = torch.empty(out_f, in_f)  # drawn on the generator's CPU
        m.weight.copy_(uniform_(w, xavier_bound(in_f, out_f), generator))
        if m.bias is not None:
            m.bias.zero_()
