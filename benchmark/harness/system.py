"""The system under test: the port's fold graph, fold context and model,
built from the benchmark's inputs through the port's own entry points
(Graph, make_fold_context, Config, MultilevelGNN), and its launch
counters.  With traffic.py, the only modules of the harness that import
the port."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def config(conf: dict):
    from multilevel_gnn_tpu_torch.core.config import Config

    return Config.from_dict(dict(conf["config"]))


def fold_context(conf: dict, fold: dict, pca_seed: torch.Tensor, device):
    """The port's FoldContext: the self-looped, windowed, plan-carrying
    graph and the PCA-row tables, on ``device``."""
    from multilevel_gnn_tpu_torch.core.batch import make_fold_context
    from multilevel_gnn_tpu_torch.core.graph import Graph

    g = Graph.from_edges(np.stack([fold["senders"], fold["receivers"]]),
                         fold["edge_attr"], fold["n_nodes"]).with_self_loops()
    if conf["config"].get("windowed_spmm"):
        g = g.with_window_meta(perm_group=conf["fold"]["window_perm_group"])
    g = g.with_sorted_meta(device)
    return make_fold_context(
        g, fold["gene_pca_match"], fold["raw_indice"], fold["info_mask"],
        reorder_idxs=fold["reorder"], pca_seed=pca_seed.cpu().numpy(),
        n_pathways=fold["n_pathways"], device=device)


def model(cfg, ctx, weights: Dict[str, torch.Tensor], device):
    """MultilevelGNN for the fold with the benchmark's weights copied in;
    raises unless its leaves are exactly the weights' names and shapes."""
    from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN

    m = MultilevelGNN(cfg, ctx.graph.n_nodes, ctx.num_pca_rows, device=device)
    params = dict(m.named_parameters())
    want = {k: tuple(v.shape) for k, v in weights.items() if k != "pca_seed"}
    have = {k: tuple(v.shape) for k, v in params.items()}
    if want != have:
        raise RuntimeError(f"the model's leaves differ from the benchmark's: "
                           f"{sorted(set(want.items()) ^ set(have.items()))}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(weights[k])
    return m


def kernel_launches() -> Dict[str, int]:
    """The port's launch counters of its hand-written kernels."""
    from multilevel_gnn_tpu_torch.ops.kernels import build

    return {k.name: k.launches for k in build.REGISTRY.values()}
