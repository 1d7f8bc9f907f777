"""GBM-scale synthetic flagship inputs (port of
multilevel_gnn_tpu/data/synthetic.py: make_cohort_topology :157-196,
make_gbm_scale_setup :199-281).

Numpy only up to the tensors: with the same seed the edge arrays, context
arrays and batch are bit-identical to the JAX package's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multilevel_gnn_tpu_torch.core.batch import Batch, make_fold_context
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.core.device import resolve_device
from multilevel_gnn_tpu_torch.core.graph import Graph


def make_cohort_topology(
    rng,
    n_genes: int = 5135,
    e_ppi: int = 45_000,
    hub_frac: float = 0.10,
    community: int = 60,
):
    """GBM-scale cohort-like edge list (no self loops): 90% of gene edges
    community-banded + 10% uniform hub edges, each replicated over the 3
    interleaved omics slots (node = 3*gene+omics), plus CNV->mRNA and
    MT->mRNA cross-omics edges between adjacent slots.  Returns (senders,
    receivers, n_nodes)."""
    n_comm = (n_genes + community - 1) // community
    e_local = int(e_ppi * (1 - hub_frac))
    c = rng.randint(0, n_comm, e_local)
    lo = c * community
    s = lo + rng.randint(0, community, e_local)
    d = lo + rng.randint(0, community, e_local)
    keep = (s < n_genes) & (d < n_genes)
    src_g, dst_g = s[keep], d[keep]
    e_hub = e_ppi - len(src_g)
    hubs = rng.choice(n_genes, 20, replace=False)
    hs = hubs[rng.randint(0, 20, e_hub)]
    hd = rng.randint(0, n_genes, e_hub)
    src_g = np.concatenate([src_g, hs])
    dst_g = np.concatenate([dst_g, hd])
    src, dst = [], []
    for oi in range(3):
        src.append(3 * src_g + oi)
        dst.append(3 * dst_g + oi)
    genes = rng.choice(n_genes, n_genes // 2, replace=False)
    src.append(3 * genes + 1)
    dst.append(3 * genes)
    src.append(3 * genes + 2)
    dst.append(3 * genes)
    return np.concatenate(src), np.concatenate(dst), 3 * n_genes


def make_gbm_scale_setup(
    node_num: int = 5135,
    n_pathways: int = 146,
    n_edges: int = 150_000,
    batch: int = 32,
    gene_rows: int = 25015,
    seed: int = 0,
    topology: str = "random",
    windowed: bool = False,
    topo_seed: Optional[int] = None,
    device="cuda",
    compute_dtype: Optional[str] = None,
    spmm_bf16: bool = False,
    gnn_name: str = "sage",
):
    """GBM-production-scale flagship inputs built directly: N = 3*node_num
    node slots, self-looped edges, B patients, C = 64.  Returns (cfg, model,
    graph, ctx, batch) on ``device``; the model's weights are drawn from a
    torch.Generator seeded with ``seed``.

    topology: 'random' (uniform edges) or 'cohort' (make_cohort_topology).
    windowed=True attaches the windowed-SpMM plan (perm_group=3).
    compute_dtype / spmm_bf16 set the trunk's precision as in the shipped
    configs ('bfloat16', True).  gnn_name picks the conv (sage, rsage,
    mr or edge); nothing else, the arrays included, depends on it."""
    from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN

    dev = resolve_device(device)
    rng_data = np.random.RandomState(seed)
    rng = np.random.RandomState(seed if topo_seed is None else topo_seed)
    K = 2
    nodes = 3 * node_num
    cfg = Config(
        model="multilevel_gnn", gnn_name=gnn_name, gnn_act="leakyrelu",
        num_layers=2, hidden_channels=64, final_channels=32,
        node_embedding=True, node_embedding_dim=64, node_num=node_num,
        pathway_num=n_pathways, pca_dim=K, pca_sim_dim=K, pathway_pool_dim=4,
        pca_pool_dim=2, conv_channel_list=[32, 64], conv_kernel_list=[1, 1],
        head_dim=256, use_age=True, value_att_mask=True,
        mutual_info_mask=True, pca_match_mask=True, weighted_edge=True,
        pca_indep_loss=True, feature_drop=True, weight_balance=True,
        batch_size=batch, kernel_backend="pallas",
        compute_dtype=compute_dtype, spmm_bf16=spmm_bf16,
        windowed_spmm=windowed,
    )
    if topology == "cohort":
        send, recv, nodes_t = make_cohort_topology(rng, n_genes=node_num)
        if nodes_t != nodes:
            raise ValueError((nodes_t, nodes))
        attr = rng.rand(len(send)).astype(np.float32)
        graph = Graph.from_edges(np.stack([send, recv]), attr, nodes)
    else:
        graph = Graph.from_edges(
            rng.randint(0, nodes, size=(2, n_edges)),
            rng.rand(n_edges).astype(np.float32),
            nodes,
        )
    graph = graph.with_self_loops()
    if windowed:
        graph = graph.with_window_meta(perm_group=3)
    graph = graph.with_sorted_meta(dev)
    ctx = make_fold_context(
        graph,
        rng.randint(-1, nodes, gene_rows),
        np.sort(rng.randint(0, 3 * n_pathways, gene_rows)),
        (rng.rand(gene_rows, 1) > 0.3).astype(np.float32),
        n_pathways=n_pathways,
        device=dev,
    )
    b = Batch(
        x=torch.as_tensor(rng_data.randn(batch, nodes).astype(np.float32)).to(dev),
        y=torch.as_tensor(
            np.eye(2, dtype=np.float32)[rng_data.randint(0, 2, batch)]
        ).to(dev),
        age=torch.as_tensor(rng_data.rand(batch).astype(np.float32) * 80).to(dev),
        sample_mask=torch.ones(batch, dtype=torch.bool, device=dev),
    )
    model = MultilevelGNN(cfg, nodes, gene_rows, device=dev, seed=seed)
    return cfg, model, graph, ctx, b
