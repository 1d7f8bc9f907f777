"""MultilevelGNN, the flagship model, eval and training forward (port of
multilevel_gnn_tpu/models/multilevel_gnn.py: ConvHead :64-134,
MultilevelGNN encode / gnn_stack / gather_pca_rows / learnable_pca_image
:137-321, get_feature_loss :359-404, seed_pca_params :457-470).

  node embedding outer product -> GNN stack (gnn_name sage, rsage, mr or
  edge) -> value-attention mask ->
  gene -> PCA-row gather -> learnable-PCA pathway contraction -> optional
  pathway reorder -> ConvHead (1x1 convs, MaxPool, flatten, age, MLP,
  softmax).

The trunk is node-major, (N, B, C), and runs in cfg.compute_dtype; the
image, head and outputs are float32.  Parameter names follow the flax
module paths (gnn_0.gconv.lin_r, conv_head.Conv_0, ...) so interop.py maps
one onto the other.  In ``model.train()`` the dropouts the shipped configs
reach (input_drop, input_emb_drop, the SAGE MLP's gnn_dropout, the head's
feature_drop and head_drop_rate) draw their masks from the generator
passed to forward; mr and edge take no gnn_dropout, as in JAX.  Branches
outside the ported paths raise NotImplementedError.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multilevel_gnn_tpu_torch.core.batch import Batch, FoldContext
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.core.device import resolve_device
from multilevel_gnn_tpu_torch.nn.basic import Dropout, Linear, uniform_, xavier_bound
from multilevel_gnn_tpu_torch.nn.conv import GraphConvLayer
from multilevel_gnn_tpu_torch.ops.pathway import pathway_contract, slot_onehot, slots_to_image
from multilevel_gnn_tpu_torch.ops.spmm import gather_rows


def compute_dtype(cfg: Config) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.compute_dtype in ("bfloat16", "bf16") else None


def _check_supported(cfg: Config) -> None:
    unported = {
        "resgnn": cfg.resgnn,
        "dense_gnn": cfg.dense_gnn,
        "repeat_mask": cfg.repeat_mask,
        "edge_type=merge": cfg.edge_type == "merge",
        "pca_prelinear": cfg.pca_prelinear,
        "only_mrna_pred": cfg.only_mrna_pred,
        "used_omics!='012'": cfg.used_omics != "012",
        "reduction_method!='linear_projection'":
            cfg.reduction_method != "linear_projection",
        # mr and edge ignore gnn_mlp_norm, as GraphConvLayer does in JAX
        "gnn_mlp_norm": str(cfg.gnn_mlp_norm).lower() != "none"
        and cfg.gnn_name.lower() in ("sage", "rsage"),
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"MultilevelGNN options not ported yet: {bad}")


class ConvHead(nn.Module):
    """PathCNN-style head on the (B, C, P, 3K) NCHW image: conv stack,
    MaxPool (window = stride = (pathway_pool_dim, pca_pool_dim), floor),
    feature dropout, NCHW flatten, age concat, MLP, softmax."""

    def __init__(self, cfg: Config, in_channels: int, generator=None):
        super().__init__()
        self.cfg = cfg
        ch = in_channels
        self.n_conv = len(cfg.conv_channel_list)
        for i, (out_ch, k) in enumerate(
            zip(cfg.conv_channel_list, cfg.conv_kernel_list)
        ):
            conv = nn.Conv2d(ch, out_ch, k, padding=k // 2)
            uniform_(conv.weight, xavier_bound(ch * k * k, out_ch * k * k), generator)
            nn.init.zeros_(conv.bias)
            self.add_module(f"Conv_{i}", conv)
            ch = out_ch
        h = cfg.pathway_num // cfg.pathway_pool_dim
        w = (3 * cfg.pca_dim) // cfg.pca_pool_dim
        flat = ch * h * w + (1 if cfg.use_age else 0)
        self.feature_drop = Dropout(0.25 if cfg.feature_drop else 0.0)
        self.head_0 = Linear(flat, cfg.head_dim, kernel_init="xavier", generator=generator)
        self.head_drop = Dropout(cfg.head_drop_rate)
        self.head_1 = Linear(cfg.head_dim, 2, kernel_init="xavier", generator=generator)

    def forward(
        self, x: torch.Tensor, age: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        cfg = self.cfg
        h = x
        for i in range(self.n_conv):
            h = F.relu(getattr(self, f"Conv_{i}")(h))
        h = F.max_pool2d(
            h,
            kernel_size=(cfg.pathway_pool_dim, cfg.pca_pool_dim),
            stride=(cfg.pathway_pool_dim, cfg.pca_pool_dim),
        )
        h = self.feature_drop(h, generator)
        h = h.reshape(h.shape[0], -1)
        if cfg.use_age:
            h = torch.cat([h, age[:, None].to(h.dtype)], dim=-1)
        h = F.relu(self.head_0(h))
        h = self.head_drop(h, generator)
        return torch.softmax(self.head_1(h), dim=-1)


class MultilevelGNN(nn.Module):
    """The flagship model for one fold's shapes.

    n_nodes: node slots (3 * genes); num_pca_rows: G.  Parameters are drawn
    from ``generator`` (a CPU torch.Generator; seeded from ``seed`` when
    None) and moved to ``device``."""

    def __init__(
        self,
        cfg: Config,
        n_nodes: int,
        num_pca_rows: int,
        device="cuda",
        generator: Optional[torch.Generator] = None,
        seed: int = 0,
    ):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        cdt = compute_dtype(cfg)
        spmm_dtype = torch.bfloat16 if cfg.spmm_bf16 else None
        if cfg.node_embedding:
            self.node_embedding = nn.Parameter(
                torch.empty(n_nodes, cfg.node_embedding_dim)
            )
            self._init_embedding(generator)
            emb_dim = cfg.node_embedding_dim
        else:
            self.node_embedding = None
            emb_dim = 1
        dims = (
            [(emb_dim, cfg.hidden_channels)]
            + [(cfg.hidden_channels, cfg.hidden_channels)]
            * max(cfg.num_layers - 2, 0)
            + [(cfg.hidden_channels, cfg.final_channels)]
        )
        self.n_layers = len(dims)
        for i, (cin, cout) in enumerate(dims):
            last = i == self.n_layers - 1
            self.add_module(
                f"gnn_{i}",
                GraphConvLayer(
                    cin, cout, conv=cfg.gnn_name, act_type=cfg.gnn_act,
                    norm=cfg.gnn_last_norm if last else None,
                    mlp_norm=cfg.gnn_mlp_norm, drop=cfg.gnn_dropout,
                    dtype=cdt, spmm_dtype=spmm_dtype, generator=generator,
                ),
            )
        self.learnable_pca_params = nn.Parameter(
            torch.empty(num_pca_rows, cfg.pca_dim)
        )
        self._init_pca(generator)
        self.input_drop = Dropout(cfg.input_drop)
        self.input_emb_drop = Dropout(cfg.input_emb_drop)
        self.conv_head = ConvHead(cfg, cfg.final_channels, generator)
        self.to(dev)

    def _init_embedding(self, g):
        cfg, p = self.cfg, self.node_embedding
        with torch.no_grad():
            t = cfg.embedding_init_type
            if t == "xavier":
                uniform_(p, xavier_bound(p.shape[1], p.shape[0]), g)
            elif t == "ones":
                p.fill_(1.0)
            elif t == "constant":
                p.fill_(cfg.emb_val)
            else:
                p.uniform_(0.0, 1.0, generator=g)

    def _init_pca(self, g):
        cfg, p = self.cfg, self.learnable_pca_params
        with torch.no_grad():
            if cfg.pca_init_type is None:
                uniform_(p, xavier_bound(p.shape[1], p.shape[0]), g)
            elif cfg.pca_init_type == "orthogonal":
                nn.init.orthogonal_(p, generator=g)
            else:
                p.uniform_(0.0, 1.0, generator=g)

    def forward(
        self, batch: Batch, ctx: FoldContext,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (softmax probabilities (B, 2), pathway image (B, C, P, 3K)).
        generator: the dropout masks' source in training mode."""
        image = self.encode(batch, ctx, generator)
        return self.conv_head(image, batch.age, generator), image

    def gnn_stack(self, x, mask_x, ctx: FoldContext, generator=None):
        """x: (N, B, D) node-major; mask_x: (N, B)."""
        cfg = self.cfg
        cdt = compute_dtype(cfg)
        edge_attr = ctx.graph.edge_attr if cfg.weighted_edge else None
        if cdt is not None:
            x = x.to(cdt)
            mask_x = mask_x.to(cdt)
        for i in range(self.n_layers):
            x = getattr(self, f"gnn_{i}")(x, ctx.graph, edge_attr, generator)
        if cfg.value_att_mask:
            if cfg.merge_mode == "mult":
                x = x * mask_x[..., None]
            else:
                x = cfg.add_coef1 * x + cfg.add_coef2 * mask_x[..., None]
        return x

    def gather_pca_rows(self, x, ctx: FoldContext):
        """Gene -> PCA-row gather, -1 = last node slot (resolved on host);
        its backward is K1 over the fold's pca_gather plan."""
        xg = gather_rows(x, ctx.pca_rows, ctx.pca_gather)
        if self.cfg.pca_match_mask:
            keep = (ctx.gene_pca_match >= 0).to(x.dtype)
            xg = xg * keep[:, None, None]
        return xg

    def learnable_pca_image(self, xg, ctx: FoldContext):
        cfg = self.cfg
        pca = self.learnable_pca_params
        if cfg.freeze_pca_weight:
            pca = pca.detach()
        if cfg.mutual_info_mask or cfg.final_channels != 1:
            p = pca * ctx.info_mask
        else:
            p = pca
        out = pathway_contract(xg, p, ctx.raw_indice, 3 * cfg.pathway_num)
        image = slots_to_image(out, cfg.pathway_num)
        if cfg.reorder_pathway:
            image = image.index_select(2, ctx.reorder_idxs)
        return image

    def encode(self, batch: Batch, ctx: FoldContext, generator=None):
        cfg = self.cfg
        mask_x = batch.x.T  # (N, B)
        x = self.input_drop(batch.x, generator).T
        if self.node_embedding is not None:
            emb = self.node_embedding
            if cfg.freeze_node_embedding:
                emb = emb.detach()
            h = x[..., None] * emb[:, None, :]  # (N, B, D)
        else:
            h = x[..., None]
        h = self.input_emb_drop(h, generator)
        h = self.gnn_stack(h, mask_x, ctx, generator)
        xg = self.gather_pca_rows(h, ctx)
        image = self.learnable_pca_image(xg, ctx)
        return image.float()


def get_feature_loss(
    pca_params: torch.Tensor,
    ctx: FoldContext,
    pca_feature: torch.Tensor,
    cfg: Config,
    sample_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Auxiliary losses (multilevel_gnn.py:359-404).

    pca_loss: -coef * log(mean(std over the batch)), ddof 1, padding rows
    masked out.  pca_indep_loss: mean |cos| between learnable-PCA columns
    per pathway slot.  The reference's quirks are kept: the params are
    detached, so this term carries no gradient, and only the last j of
    each i is added."""
    loss = torch.zeros((), dtype=torch.float32, device=pca_feature.device)
    if cfg.pca_loss:
        b = pca_feature.shape[0]
        flat = pca_feature.reshape(b, -1)
        if sample_mask is not None:
            m = sample_mask.to(flat.dtype)[:, None]
            nb = torch.clamp(m.sum(), min=2.0)
            mean = (flat * m).sum(0) / nb
            std = torch.sqrt(((flat - mean) ** 2 * m).sum(0) / (nb - 1.0))
        else:
            std = torch.std(flat, dim=0, correction=1)
        loss = loss - cfg.pca_loss_coef * torch.log(torch.mean(std))
    if cfg.pca_indep_loss:
        p = (pca_params * ctx.info_mask).detach()
        M = slot_onehot(ctx.raw_indice, 3 * cfg.pathway_num)  # (S, G)
        indep = torch.zeros((), dtype=torch.float32, device=p.device)
        count = 0
        for i in range(cfg.pca_dim - 1):
            for j in range(i + 1, cfg.pca_dim):
                count += 1
                mul_res = M @ (p[:, i] * p[:, j])
                len_res = torch.sqrt((M @ (p[:, i] ** 2)) * (M @ (p[:, j] ** 2)))
            indep = indep + torch.mean(torch.abs(mul_res / (len_res + 1e-7)))
        loss = loss + indep / count
    return loss


@torch.no_grad()
def seed_pca_params(model: MultilevelGNN, pca_seed: torch.Tensor) -> None:
    """Replace the learnable PCA params with the PCA-seeded value in place
    (multilevel_gnn.py:457-470, reference set_pca_params)."""
    p = model.learnable_pca_params
    if tuple(p.shape) != tuple(pca_seed.shape):
        raise ValueError(f"pca_seed {tuple(pca_seed.shape)} vs params {tuple(p.shape)}")
    p.copy_(pca_seed.to(p.device, p.dtype))
