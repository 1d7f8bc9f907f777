"""PathCNN, the no-GNN baseline (port of multilevel_gnn_tpu/models/pathcnn.py:
PathCNN :21-75).

With learnable_pca, the learnable-PCA contraction of the raw mean-centred
omics values (batch.raw_data, (B, G)) into the (B, 1, P, 3K) pathway
image; without it, batch.raw_data carries the fold's precomputed pathway
PCA attrs, (B, P * 3K).  Then conv1 (1 -> 32) and conv2 (32 -> 64), or
more_conv's three 64-channel convs, each kernel pathcnn_kernel_size with
padding k // 2, MaxPool (pathway_pool_dim, pca_pool_dim), dropout 0.25,
flatten, age, head_0, dropout 0.5, head_1, softmax.  No port kernel runs
here: the contraction is the dense pathway product of ops/pathway.py.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multilevel_gnn_tpu_torch.core.batch import Batch, FoldContext
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.core.device import resolve_device
from multilevel_gnn_tpu_torch.models.multilevel_gnn import _Conv2d, _pca_param_init
from multilevel_gnn_tpu_torch.nn.basic import Dropout, Linear, uniform_, xavier_bound
from multilevel_gnn_tpu_torch.ops.pathway import pathway_contract, slots_to_image


def xavier_conv(in_ch: int, out_ch: int, k: int, generator) -> nn.Conv2d:
    """flax nn.Conv with Xavier-uniform kernel and zero bias, padding k // 2."""
    conv = nn.Conv2d(in_ch, out_ch, k, padding=k // 2)
    uniform_(conv.weight, xavier_bound(in_ch * k * k, out_ch * k * k), generator)
    nn.init.zeros_(conv.bias)
    return conv


class PathCNN(nn.Module):
    """forward(batch, ctx, generator) -> (probabilities (B, 2), pathway image
    (B, 1, P, 3K)).  The constructor takes MultilevelGNN's arguments
    (n_nodes is unused); parameters are drawn from ``generator`` (seeded
    from ``seed`` when None) and moved to ``device``."""

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
        if cfg.learnable_pca:
            self.learnable_pca_params = nn.Parameter(torch.empty(num_pca_rows, cfg.pca_dim))
            _pca_param_init(self.learnable_pca_params, cfg, generator)
        else:
            self.register_parameter("learnable_pca_params", None)
        k = cfg.pathcnn_kernel_size
        self.conv1 = xavier_conv(1, 32, k, generator)
        if cfg.more_conv:
            self.convs2 = ["conv2_0", "conv2_1", "conv2_2"]
            for i, name in enumerate(self.convs2):
                self.add_module(name, xavier_conv(32 if i == 0 else 64, 64, k, generator))
        else:
            self.convs2 = ["conv2"]
            self.conv2 = xavier_conv(32, 64, k, generator)
        h, w = cfg.pathway_num, 3 * cfg.pca_dim
        for _ in range(1 + len(self.convs2)):
            h, w = h + 2 * (k // 2) - k + 1, w + 2 * (k // 2) - k + 1
        flat = 64 * (h // cfg.pathway_pool_dim) * (w // cfg.pca_pool_dim) + 1
        self.feature_drop = Dropout(0.25)
        self.head_0 = Linear(flat, cfg.head_dim, kernel_init="xavier", generator=generator)
        self.head_drop = Dropout(0.5)
        self.head_1 = Linear(cfg.head_dim, 2, kernel_init="xavier", generator=generator)
        self.to(dev)

    def image(self, batch: Batch, ctx: FoldContext) -> torch.Tensor:
        cfg = self.cfg
        P, K = cfg.pathway_num, cfg.pca_dim
        if not cfg.learnable_pca:
            return batch.raw_data.reshape(-1, 1, P, 3 * K)
        pca = self.learnable_pca_params
        p = pca * ctx.info_mask if cfg.mutual_info_mask else pca
        out = pathway_contract(batch.raw_data.T[..., None], p, ctx.raw_indice, 3 * P,
                               ctx.slot_plan)
        return slots_to_image(out, P)

    def forward(
        self, batch: Batch, ctx: FoldContext,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x = self.image(batch, ctx)

        def conv(name, h):
            c = getattr(self, name)
            return _Conv2d.apply(h, c.weight, c.bias, c.padding[0])

        h = F.relu(conv("conv1", x))
        for i, name in enumerate(self.convs2):
            h = conv(name, h)
            if i < len(self.convs2) - 1:
                h = F.relu(h)
        h = F.relu(h)
        pool = (cfg.pathway_pool_dim, cfg.pca_pool_dim)
        h = F.max_pool2d(h, kernel_size=pool, stride=pool)
        h = self.feature_drop(h, generator)
        h = torch.cat([h.reshape(h.shape[0], -1), batch.age[:, None].to(h.dtype)], dim=-1)
        h = self.head_drop(F.relu(self.head_0(h)), generator)
        return torch.softmax(self.head_1(h), dim=-1), x
