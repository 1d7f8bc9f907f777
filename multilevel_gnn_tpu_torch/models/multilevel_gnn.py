"""MultilevelGNN, the flagship model, eval and training forward (port of
multilevel_gnn_tpu/models/multilevel_gnn.py: _node_embedding_init :35,
_pca_param_init :51, ConvHead :64-134,
MultilevelGNN encode / gnn_stack / gather_pca_rows / learnable_pca_image /
runtime_pca_image :137-356, get_feature_loss :359-404, seed_pca_params
:457-470).

  node embedding outer product -> GNN stack (gnn_name sage, rsage, gcn,
  gat, gin, mr or edge; resgnn, dense_gnn and repeat_mask between the
  layers; with edge_type merge, run once over each of the fold's two
  graphs and concatenated) -> value-attention mask -> gene -> PCA-row
  gather -> learnable-PCA pathway contraction, or the runtime per-slot
  PCA (reduction_method pca_svd / pca_lowrank) -> optional pathway
  reorder -> ConvHead (optional pre-linear, convs, the used_omics columns
  or only_mrna_pred's first two, MaxPool, flatten, age, MLP, softmax).

The trunk is node-major, (N, B, C), and runs in cfg.compute_dtype (GAT in
float32, as in JAX); the image, head and outputs are float32.  Parameter
names follow the flax module paths (gnn_0.gconv.lin_r, conv_head.Conv_0,
...) so interop.py maps one onto the other.  In ``model.train()`` the
dropouts (input_drop, input_emb_drop, the SAGE MLP's gnn_dropout, the
head's feature_drop and head_drop_rate) draw their masks from the
generator passed to forward; only sage / rsage take gnn_dropout, as in
JAX.
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
from multilevel_gnn_tpu_torch.ops.pca import pca_lowrank, pca_svd
from multilevel_gnn_tpu_torch.ops.spmm import gather_rows


def compute_dtype(cfg: Config) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.compute_dtype in ("bfloat16", "bf16") else None


class _Conv2d(torch.autograd.Function):
    """F.conv2d (stride 1, dilation 1, one group) whose backward runs on
    cuDNN's deterministic algorithms.  The algorithms cuDNN picks by
    default may add the weight gradient with atomics, so two trainings
    from one state drifted apart after a few steps on an H100 and a
    resumed protocol did not repeat the uninterrupted one (PERF.md);
    the forward's algorithms are deterministic already."""

    @staticmethod
    def forward(ctx, x, w, b, padding: int):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        return F.conv2d(x, w, b, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        p = ctx.padding
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                         allow_tf32=cudnn.allow_tf32):
            dx, dw, db = torch.ops.aten.convolution_backward(
                g, x, w, [w.shape[0]], [1, 1], [p, p], [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], True])
        return dx, dw, db, None


def _omics_columns(cfg: Config) -> Optional[list]:
    """The image columns of cfg.used_omics (each omics' pca_dim columns),
    or None when all three are used (multilevel_gnn.py:104-109)."""
    if len(cfg.used_omics) == 3:
        return None
    return [c for i in cfg.used_omics
            for c in range(int(i) * cfg.pca_dim, (int(i) + 1) * cfg.pca_dim)]


class ConvHead(nn.Module):
    """PathCNN-style head on the (B, C, P, 3K) NCHW image: optional
    pre-linear over the 3K axis (pre_0..pre_2, pca_prelinear), conv stack,
    then either only_mrna_pred's first two columns (no feature dropout) or
    the used_omics columns, MaxPool (window = stride = (pathway_pool_dim,
    pca_pool_dim), floor), feature dropout, NCHW flatten, age concat, MLP,
    softmax.  width: the image's last axis (3K by default); head_0's
    width follows from those shapes, as flax infers it."""

    def __init__(self, cfg: Config, in_channels: int, generator=None,
                 width: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        width = 3 * cfg.pca_dim if width is None else width
        if cfg.pca_prelinear:
            self.pre_0 = Linear(width, 32, kernel_init="xavier", generator=generator)
            self.pre_1 = Linear(32, 32, kernel_init="xavier", generator=generator)
            self.pre_2 = Linear(32, width, kernel_init="xavier", generator=generator)
        ch, h = in_channels, cfg.pathway_num
        self.n_conv = len(cfg.conv_channel_list)
        for i, (out_ch, k) in enumerate(
            zip(cfg.conv_channel_list, cfg.conv_kernel_list)
        ):
            conv = nn.Conv2d(ch, out_ch, k, padding=k // 2)
            uniform_(conv.weight, xavier_bound(ch * k * k, out_ch * k * k), generator)
            nn.init.zeros_(conv.bias)
            self.add_module(f"Conv_{i}", conv)
            ch = out_ch
            h, width = h + 2 * (k // 2) - k + 1, width + 2 * (k // 2) - k + 1
        self.cols = None if cfg.only_mrna_pred else _omics_columns(cfg)
        if cfg.only_mrna_pred:
            width = min(width, 2)
        elif self.cols is not None:
            width = len(self.cols)
        flat = ch * (h // cfg.pathway_pool_dim) * (width // cfg.pca_pool_dim)
        flat += 1 if cfg.use_age else 0
        self.feature_drop = Dropout(
            0.25 if cfg.feature_drop and not cfg.only_mrna_pred else 0.0)
        self.head_0 = Linear(flat, cfg.head_dim, kernel_init="xavier", generator=generator)
        self.head_drop = Dropout(cfg.head_drop_rate)
        self.head_1 = Linear(cfg.head_dim, 2, kernel_init="xavier", generator=generator)

    def forward(
        self, x: torch.Tensor, age: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        cfg = self.cfg
        if cfg.pca_prelinear:
            z = F.relu(self.pre_1(F.relu(self.pre_0(x))))
            x = self.pre_2(z)
        h = x
        for i in range(self.n_conv):
            conv = getattr(self, f"Conv_{i}")
            h = F.relu(_Conv2d.apply(h, conv.weight, conv.bias, conv.padding[0]))
        if cfg.only_mrna_pred:
            h = h[..., :2]
        elif self.cols is not None:
            h = h[..., self.cols]
        pool = (cfg.pathway_pool_dim, cfg.pca_pool_dim)
        if h.shape[-2] < pool[0] or h.shape[-1] < pool[1]:
            # flax's VALID pooling of a smaller image is empty (a VAE
            # classifier's one-column image under pca_pool_dim 2)
            h = h.new_zeros(h.shape[:2] + (h.shape[-2] // pool[0], h.shape[-1] // pool[1]))
        else:
            h = F.max_pool2d(h, kernel_size=pool, stride=pool)
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
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        self._build_head(self._build_encoder(n_nodes, num_pca_rows, generator), generator)
        self.to(dev)

    def _learnable_pca(self) -> bool:
        return self.cfg.reduction_method == "linear_projection"

    def _build_encoder(self, n_nodes: int, num_pca_rows: int, generator) -> int:
        """The node embedding, the GNN stack and the learnable PCA params;
        returns the trunk's output width (the image's channels)."""
        cfg = self.cfg
        cdt = compute_dtype(cfg)
        spmm_dtype = torch.bfloat16 if cfg.spmm_bf16 else None
        if cfg.node_embedding:
            self.node_embedding = nn.Parameter(
                torch.empty(n_nodes, cfg.node_embedding_dim)
            )
            _node_embedding_init(self.node_embedding, cfg, generator)
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
        width, widths = emb_dim, []
        for i, (_, cout) in enumerate(dims):
            last = i == self.n_layers - 1
            # flax infers each layer's input width; a GAT layer returns
            # (out // heads) * heads of them
            layer = GraphConvLayer(
                width, cout, conv=cfg.gnn_name, act_type=cfg.gnn_act,
                norm=cfg.gnn_last_norm if last else None,
                heads=cfg.final_head if last else 8,
                mlp_norm=cfg.gnn_mlp_norm, drop=cfg.gnn_dropout,
                dtype=cdt, spmm_dtype=spmm_dtype, generator=generator,
            )
            self.add_module(f"gnn_{i}", layer)
            width = layer.out_width
            widths.append(width)
        if self._learnable_pca():
            self.learnable_pca_params = nn.Parameter(
                torch.empty(num_pca_rows, cfg.pca_dim)
            )
            _pca_param_init(self.learnable_pca_params, cfg, generator)
        else:
            self.register_parameter("learnable_pca_params", None)
            if cfg.slot_sizes is None:
                raise ValueError("runtime PCA reduction needs cfg.slot_sizes "
                                 "(set it from Cohort.slot_sizes())")
        self.input_drop = Dropout(cfg.input_drop)
        self.input_emb_drop = Dropout(cfg.input_emb_drop)
        # merge concatenates the two graphs' features (the reference doubles
        # final_channels for the head only), dense_gnn every layer's
        if cfg.edge_type == "merge":
            return 2 * widths[-1]
        return sum(widths) if cfg.dense_gnn else widths[-1]

    def _build_head(self, width: int, generator) -> None:
        self.conv_head = ConvHead(self.cfg, width, generator)

    def forward(
        self, batch: Batch, ctx: FoldContext,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (softmax probabilities (B, 2), pathway image (B, C, P, 3K)).
        generator: the dropout masks' source in training mode."""
        image = self.encode(batch, ctx, generator)
        return self.conv_head(image, batch.age, generator), image

    def gnn_stack(self, x, mask_x, ctx: FoldContext, generator=None,
                  apply_value_mask: bool = True):
        """x: (N, B, D) node-major; mask_x: (N, B).  apply_value_mask=False:
        no value-attention mask at the end (the AE / VAE encoders,
        multilevel_gnn.py:153-158)."""
        cfg = self.cfg
        cdt = compute_dtype(cfg)
        edge_attr = ctx.graph.edge_attr if cfg.weighted_edge else None
        # x stays f32 here: each conv casts it to cdt where it uses it.  GAT
        # promotes its input to f32, so it gets JAX's cast of the trunk
        # input to cdt first (multilevel_gnn.py:170)
        if cdt is not None:
            mask_x = mask_x.to(cdt)
            if cfg.gnn_name.lower() == "gat":
                x = x.to(cdt)
        layers = [getattr(self, f"gnn_{i}") for i in range(self.n_layers)]
        if cfg.edge_type == "merge":
            if ctx.graph2 is None:
                raise ValueError("edge_type 'merge' needs the fold's graph2")
            # multilevel_gnn.py:197-218: the same stack (shared weights) once
            # per graph, unweighted, the features concatenated, no
            # resgnn / dense_gnn / repeat_mask
            feats = []
            for g in (ctx.graph, ctx.graph2):
                h = x
                for layer in layers:
                    h = layer(h, g, None, generator)
                feats.append(h)
            x = torch.cat(feats, dim=-1)
        else:
            feats = []
            for i, layer in enumerate(layers):
                h = layer(x, ctx.graph, edge_attr, generator)
                if cfg.dense_gnn:
                    feats.append(h)
                elif cfg.resgnn:
                    # JAX adds the trunk input in cdt
                    h = h + (x.to(cdt) if i == 0 and cdt is not None else x)
                x = h
                if (i + 1 != self.n_layers and cfg.repeat_mask
                        and (i + 1) % cfg.repeat_cyclic == 0):
                    if cfg.repeat_norm:
                        # the norm's statistics in f32, the division in x's dtype
                        n2 = torch.sqrt((x.float() ** 2).sum(-1))[..., None]
                        x = x / n2.to(x.dtype)
                    x = x * mask_x[..., None]
            if cfg.dense_gnn:
                x = torch.cat(feats, dim=-1)
        if cfg.value_att_mask and apply_value_mask:
            if cfg.merge_mode == "mult":
                x = x * mask_x[..., None]
            else:
                x = cfg.add_coef1 * x + cfg.add_coef2 * mask_x[..., None]
        return x

    def gather_pca_rows(self, x, ctx: FoldContext, drop_slot0: bool = False):
        """Gene -> PCA-row gather, -1 = last node slot (resolved on host);
        its backward is K1 over the fold's pca_gather plan.  pca_match_mask
        keeps the matched rows, and drop_slot0 drops node slot 0's too (the
        AE encoders' match > 0, autoencoder.py:69)."""
        xg = gather_rows(x, ctx.pca_rows, ctx.pca_gather)
        if self.cfg.pca_match_mask:
            match = ctx.gene_pca_match
            keep = (match > 0 if drop_slot0 else match >= 0).to(x.dtype)
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
        if cfg.reduction_method == "linear_projection":
            image = self.learnable_pca_image(xg, ctx)
        else:
            image = self.runtime_pca_image(xg)
        return image.float()

    def runtime_pca_image(self, xg):
        """The per-slot PCA reduction of the gathered rows (G, B, C) into
        the (B, C, P, 3K) image (multilevel_gnn.py:323-356): each slot's
        (C, B, n_s) block projected onto its top min(K, n_s) directions
        (pca_lowrank, or pca_svd uncentred, for any other method), padded
        to K; slot extents from cfg.slot_sizes.  A Python loop over the
        3P slots, as in JAX."""
        cfg = self.cfg
        x = xg.permute(2, 1, 0)  # (C, B, G), the reference's permute
        outs, start = [], 0
        for ns in cfg.slot_sizes:
            sl = x[:, :, start:start + ns]
            start += ns
            k = min(cfg.pca_dim, ns)
            if ns == 0:
                red = x.new_zeros(x.shape[:2] + (0,))
            elif cfg.reduction_method == "pca_lowrank":
                red = pca_lowrank(sl, k, niter=cfg.pca_lowrank_niter)
            else:
                red = pca_svd(sl, k, center=False)
            outs.append(F.pad(red, (0, cfg.pca_dim - k)))
        out = torch.stack(outs).permute(2, 1, 0, 3)  # (B, C, S, K)
        return out.reshape(out.shape[0], out.shape[1], cfg.pathway_num, 3 * cfg.pca_dim)


def _node_embedding_init(p: torch.Tensor, cfg: Config, g) -> None:
    """cfg.embedding_init_type's init of the node embedding (JAX
    _node_embedding_init, multilevel_gnn.py:35-48)."""
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


def _pca_param_init(p: torch.Tensor, cfg: Config, g) -> None:
    """cfg.pca_init_type's init of the learnable PCA params (JAX
    _pca_param_init, multilevel_gnn.py:51-61)."""
    with torch.no_grad():
        if cfg.pca_init_type is None:
            uniform_(p, xavier_bound(p.shape[1], p.shape[0]), g)
        elif cfg.pca_init_type == "orthogonal":
            nn.init.orthogonal_(p, generator=g)
        else:
            p.uniform_(0.0, 1.0, generator=g)


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
    if p is None:  # a runtime PCA reduction has no PCA params
        return
    if tuple(p.shape) != tuple(pca_seed.shape):
        raise ValueError(f"pca_seed {tuple(pca_seed.shape)} vs params {tuple(p.shape)}")
    p.copy_(pca_seed.to(p.device, p.dtype))
