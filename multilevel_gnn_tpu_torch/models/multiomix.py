"""MultiOmixGCN, per-omics virtual-node encoders and a joint head (port of
multilevel_gnn_tpu/models/multiomix.py: VnodeContext :41-54,
DeeperGCNVnode :56-169, MultiOmixGCN :172-197).

  for each omics (mrna, cnv, mt): node encoder Linear(omics [+ node
  embedding]) -> pathway rows replaced by Linear(that omics' pathway
  attrs) -> res+ blocks of GENConv over the gene-level fold graph, each
  after the first followed by PathwayConv over the omics' gene -> pathway
  graph, masked to the pathway rows it reaches (res / plain: GENConv only)
  -> pathway readout (mean, MSA transformer, or maxpool-4 + Linear);
  then concat of the three, age, head MLP, softmax.

The trunk is node-major, (N, B, H), float32 throughout (JAX casts nothing
here): GENConv's and PathwayConv's messages are (E, B, H), so K3 (the max
aggregation) and K1 (the softmax sums and every gather backward) see
F = B * H features a row.  Parameter names follow the flax paths
(mrna_encoder.gcn_0..., cnv_encoder.pathway_gcn_1.msg_encoder, head_out)
for interop.py.  flax creates only the submodules a call reaches, and so
does the port: under res+ no pathway_gcn_0 (built, never called, in JAX),
under res / plain no PathwayConv, no pathway_features_encoder for an omics
without pathway attrs, no msg_encoder for an omics whose pathway graph
has no edge attrs (MultiOmixGCN.for_vnode_data reads these from the data).

Kept from the JAX package: the pathway rows share node-embedding row 0;
the MSA readout normalises the pathway axis with the batch's statistics;
the maxpool readout has no relu after its Linear.  Neither package's
driver runs this model: its forward takes (batch, vctx, pathway_attrs),
and the driver's call passes its third argument (JAX: training, here: the
dropout generator) where pathway_attrs goes, so the train CLI fails with
AttributeError in both.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from multilevel_gnn_tpu_torch.core.batch import Batch, FoldContext
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.core.device import resolve_device
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.models.deepergcn import TransformerEncoderLayer
from multilevel_gnn_tpu_torch.nn.basic import (
    Dropout,
    EmbedTable,
    Linear,
    Norm,
    uniform_,
    xavier_bound,
)
from multilevel_gnn_tpu_torch.nn.conv import GENConv, PathwayConv

OMIX_NAMES = ("mrna", "cnv", "mt")


@dataclasses.dataclass(frozen=True)
class VnodeContext:
    """The fold context and, per omics, the gene -> pathway-vnode graph over
    the same N nodes (pathway vnodes in the trailing P rows) and its (N, 1)
    mask, 1 at the pathway rows an edge reaches (Cohort.multiomix_vnode_data)."""

    base: FoldContext
    pathway_graphs: Dict[str, Graph]
    pathway_masks: Dict[str, torch.Tensor]


class DeeperGCNVnode(nn.Module):
    """One omics' encoder (multiomix.py:56-169).  edge_attr_dim: the width
    of its pathway graph's edge attrs (None: the graph has none); attr_dim:
    the width of its pathway attrs (None: none are passed)."""

    def __init__(self, cfg: Config, omix: str, edge_attr_dim: Optional[int] = 2,
                 attr_dim: Optional[int] = 2, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.cfg, self.omix = cfg, omix
        H, L, P = cfg.hidden_channels, cfg.num_layers, cfg.pathway_num
        n_feat = 5 if cfg.mul_attr else 3
        self.node_embedding_encoder = None
        if cfg.node_embedding:
            D = cfg.node_embedding_dim
            self.node_embedding_encoder = EmbedTable(cfg.node_num, D)
            uniform_(self.node_embedding_encoder.embedding, xavier_bound(cfg.node_num, D), g)
            n_feat += D
        self.node_features_encoder = Linear(n_feat, H, kernel_init="xavier", generator=g)
        self.edge_encoder = (Linear(1, H, kernel_init="xavier", generator=g)
                             if cfg.use_edge_attr else None)
        self.pathway_features_encoder = (
            Linear(attr_dim, H, kernel_init="xavier", generator=g)
            if cfg.pathway_global_node and attr_dim is not None else None)
        for i in range(L):
            self.add_module(f"gcn_{i}", GENConv(
                H, H, aggr=cfg.gcn_aggr, t=cfg.t, learn_t=cfg.learn_t, p=cfg.p,
                learn_p=cfg.learn_p, msg_norm=cfg.msg_norm,
                learn_msg_scale=cfg.learn_msg_scale,
                encode_edge=cfg.conv_encode_edge and cfg.use_edge_attr, edge_feat_dim=H,
                norm_type=cfg.norm, mlp_layers=cfg.mlp_layers, generator=g))
        if cfg.block == "res+":
            for i in range(1, L):
                self.add_module(f"pathway_gcn_{i}", PathwayConv(
                    H, H, edge_feat_dim=edge_attr_dim, aggr=cfg.gcn_aggr, t=cfg.t,
                    learn_t=cfg.learn_t, norm_type=cfg.norm, mlp_layers=cfg.mlp_layers,
                    generator=g))
        for i in range(L):
            self.add_module(f"norm_{i}", Norm(cfg.norm, H))
        self.drop = Dropout(cfg.dropout)
        if cfg.pathway_readout == "MSA":
            self.pred_norm_scale = nn.Parameter(torch.ones(P))
            self.pred_norm_bias = nn.Parameter(torch.zeros(P))
            self.readout_msa = TransformerEncoderLayer(H, generator=g)
        elif cfg.pathway_readout is not None:  # any other name: maxpool (:154-159)
            self.readout = Linear(H * (P // 4), H, kernel_init="xavier", generator=g)

    def encode(self, batch: Batch, ctx: VnodeContext, pathway_attr) -> torch.Tensor:
        """(N, B, H) float32 ahead of the blocks."""
        P = self.cfg.pathway_num
        x = batch.x.transpose(0, 1)  # (N, B, omics)
        N, B = x.shape[0], x.shape[1]
        if self.node_embedding_encoder is not None:
            table = self.node_embedding_encoder.embedding
            emb = torch.cat([table[: N - P], table[:1].expand(P, -1)])
            x = torch.cat([x, emb[:, None, :].expand(N, B, emb.shape[1])], dim=-1)
        h = self.node_features_encoder(x)
        if self.pathway_features_encoder is not None and pathway_attr is not None:
            p_emb = self.pathway_features_encoder(pathway_attr.transpose(0, 1))
            h = torch.cat([h[: N - P], p_emb])
        return h

    def forward(self, batch: Batch, ctx: VnodeContext, pathway_attr,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg, L, P = self.cfg, self.cfg.num_layers, self.cfg.pathway_num
        graph = ctx.base.graph
        h = self.encode(batch, ctx, pathway_attr)
        e = None
        if self.edge_encoder is not None and graph.edge_attr is not None:
            e = self.edge_encoder(graph.edge_attr[:, :1])
        pgraph = ctx.pathway_graphs[self.omix]
        pmask = ctx.pathway_masks[self.omix]
        gcn = [getattr(self, f"gcn_{i}") for i in range(L)]
        norm = [getattr(self, f"norm_{i}") for i in range(L)]

        def drop(v):
            return self.drop(v, generator)

        if cfg.block == "res+":
            h = gcn[0](h, graph, e, generator)
            for i in range(1, L):
                h2 = drop(torch.relu(norm[i - 1](h)))
                h2 = gcn[i](h2, graph, e, generator)
                pconv = getattr(self, f"pathway_gcn_{i}")
                h = pconv(h2, pgraph, pgraph.edge_attr, pmask, generator) + h2
            h = drop(norm[L - 1](h))
        else:  # res / plain: the gene-graph stack alone
            h = drop(torch.relu(norm[0](gcn[0](h, graph, e, generator))))
            for i in range(1, L):
                h2 = norm[i](gcn[i](h, graph, e, generator))
                h = drop(torch.relu(h2) + h if cfg.block == "res" else torch.relu(h2))
        pw = h[h.shape[0] - P:].transpose(0, 1)  # (B, P, H)
        if cfg.pathway_readout is None:
            return pw.mean(1)
        if cfg.pathway_readout == "MSA":
            m = pw.mean(dim=(0, 2), keepdim=True)
            v = pw.var(dim=(0, 2), unbiased=False, keepdim=True)
            pwn = (pw - m) * torch.rsqrt(v + 1e-5)
            pwn = pwn * self.pred_norm_scale[None, :, None] + self.pred_norm_bias[None, :, None]
            return self.readout_msa(pwn, generator).mean(1)
        Bn, _, H = pw.shape
        t = pw.transpose(1, 2)[:, :, : (P // 4) * 4]
        return self.readout(t.reshape(Bn, H, P // 4, 4).amax(-1).reshape(Bn, -1))


class MultiOmixGCN(nn.Module):
    """MultiOmixGCN for one cohort's shapes, read from cfg: node_num (genes
    + pathway vnodes), pathway_num.  forward(batch, vctx, pathway_attrs,
    generator) -> (softmax probabilities (B, num_tasks), None):
    batch.x (B, N, omics) with zero pathway rows, vctx a VnodeContext,
    pathway_attrs a dict omics -> (B, P, A) (a missing omics gets none);
    generator: the dropout masks' source in training mode.  edge_attr_dims
    / attr_dims: per omics, the width of its pathway graph's edge attrs and
    of its pathway attrs, or None (default 2 each, as multiomix_vnode_data
    gives them).  Parameters are drawn from ``generator`` (a CPU
    torch.Generator; seeded from ``seed`` when None) and moved to
    ``device``."""

    def __init__(self, cfg: Config, device="cuda", generator: Optional[torch.Generator] = None,
                 seed: int = 0, edge_attr_dims: Optional[Mapping[str, Optional[int]]] = None,
                 attr_dims: Optional[Mapping[str, Optional[int]]] = None):
        super().__init__()
        if cfg.block not in ("res+", "res", "plain"):
            raise NotImplementedError(f"MultiOmixGCN block {cfg.block!r}")
        g = generator if generator is not None else torch.Generator().manual_seed(seed)
        self.cfg = cfg
        edge_attr_dims = edge_attr_dims if edge_attr_dims is not None else {}
        attr_dims = attr_dims if attr_dims is not None else {}
        for omix in OMIX_NAMES:
            self.add_module(f"{omix}_encoder", DeeperGCNVnode(
                cfg, omix, edge_attr_dims.get(omix, 2), attr_dims.get(omix, 2), g))
        head_in = 3 * cfg.hidden_channels + (1 if cfg.use_age else 0)
        for i in range(cfg.num_layer_head - 1):
            self.add_module(f"head_{i}", Linear(head_in, head_in, kernel_init="xavier",
                                                generator=g))
        self.head_drop = Dropout(cfg.dropout if cfg.head_dropout else 0.0)
        self.head_out = Linear(head_in, cfg.num_tasks, kernel_init="xavier", generator=g)
        self.to(resolve_device(device))

    @classmethod
    def for_vnode_data(cls, cfg: Config, graphs: Mapping[str, Graph],
                       attrs: Mapping[str, Optional[torch.Tensor]], **kw) -> "MultiOmixGCN":
        """The model whose submodules match what these pathway graphs and
        attrs reach, as flax would create them."""
        edge = {o: (None if graphs[o].edge_attr is None else int(graphs[o].edge_attr.shape[-1]))
                for o in OMIX_NAMES}
        attr = {o: (None if attrs.get(o) is None else int(attrs[o].shape[-1]))
                for o in OMIX_NAMES}
        return cls(cfg, edge_attr_dims=edge, attr_dims=attr, **kw)

    def forward(self, batch: Batch, vctx: VnodeContext, pathway_attrs,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        h = torch.cat([getattr(self, f"{o}_encoder")(batch, vctx, pathway_attrs.get(o), generator)
                       for o in OMIX_NAMES], dim=-1)
        if cfg.use_age:
            h = torch.cat([h, batch.age[:, None].float()], dim=-1)
        for i in range(cfg.num_layer_head - 1):
            h = self.head_drop(torch.relu(getattr(self, f"head_{i}")(h)), generator)
        return torch.softmax(self.head_out(h), dim=-1), None
