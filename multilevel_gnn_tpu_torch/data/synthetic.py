"""Synthetic cohorts and GBM-scale flagship inputs (port of
multilevel_gnn_tpu/data/synthetic.py: make_synthetic_tables :19-70,
make_synthetic_cohort :73-87, write_reference_format :90-154,
make_cohort_topology :157-196, make_gbm_scale_setup :199-281).

Numpy only up to the tensors: with the same seed the tables (the same
np.random.RandomState draws in the same order), edge arrays, context arrays
and batch are bit-identical to the JAX package's.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from multilevel_gnn_tpu_torch.core.batch import Batch, make_fold_context
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.core.device import resolve_device
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.data.frame import Frame, KeggTable


def make_synthetic_tables(
    n_patients: int = 60,
    n_pathways: int = 8,
    genes_per_pathway: int = 12,
    overlap: int = 3,
    n_edges: int = 300,
    seed: int = 0,
):
    """(omics {name: Frame}, clinical {field: {patient: value}}, KeggTable,
    pathways, edges, edge_attrs): P pathways of genes_per_pathway genes
    sharing ``overlap`` with the next, three omics with a survival-linked
    signal in about 40% of the genes, a GRNBoost2-style edge list."""
    rng = np.random.RandomState(seed)
    n_genes = n_pathways * (genes_per_pathway - overlap) + overlap
    entrez = np.arange(1001, 1001 + n_genes)
    pathways = [f"hsa{100 + i}" for i in range(n_pathways)]
    kp, ks, ke = [], [], []
    for pi, p in enumerate(pathways):
        start = pi * (genes_per_pathway - overlap)
        for g in entrez[start : start + genes_per_pathway]:
            kp.append(p)
            ks.append(f"G{g}")
            ke.append(int(g))
    kegg = KeggTable(kp, ks, ke)

    patients = [f"TCGA-{i:04d}" for i in range(n_patients)]
    risk = rng.randn(n_patients)
    surv = np.clip(30 + -10 * risk + rng.randn(n_patients) * 6, 1, 120)
    state = (rng.rand(n_patients) < 0.6).astype(int)
    age = rng.uniform(30, 85, n_patients).round(1)
    clinical = {
        "survive_time": dict(zip(patients, surv.tolist())),
        "survive_state": dict(zip(patients, state.tolist())),
        "age": dict(zip(patients, age.tolist())),
    }
    omics: Dict[str, Frame] = {}
    informative = rng.rand(n_genes) < 0.4
    for name, scale in [("mrna", 1.0), ("cnv", 0.5), ("methylation", 0.8)]:
        base = rng.randn(n_patients, n_genes) * scale
        base[:, informative] += np.outer(risk, rng.randn(informative.sum())) * 0.8
        omics[name] = Frame(base, patients, [str(g) for g in entrez])

    edges: Dict[int, List[Tuple[int, int]]] = {}
    edge_attrs: Dict[int, List[float]] = {}
    for _ in range(n_edges):
        s, d = rng.choice(entrez, 2, replace=False)
        edges.setdefault(int(s), []).append((int(s), int(d)))
        edge_attrs.setdefault(int(s), []).append(float(rng.rand() * 0.5 + 0.01))
    return omics, clinical, kegg, pathways, edges, edge_attrs


def make_synthetic_cohort(cfg: Config, seed: int = 0, **kw):
    """A Cohort of make_synthetic_tables(seed, **kw)."""
    from multilevel_gnn_tpu_torch.data.cohort import Cohort

    omics, clinical, kegg, pathways, edges, edge_attrs = make_synthetic_tables(
        seed=seed, **kw
    )
    cfg = cfg.replace(pathway_num=len(pathways))
    return Cohort(omics, clinical, kegg, pathways, edges, edge_attrs, cfg)


def _write_csv(path: str, df: Frame) -> None:
    """The table as pandas' to_csv writes it (an empty first header cell,
    the row label first), floats with repr so they read back exactly."""
    with open(path, "w") as f:
        f.write(",".join([""] + df.columns) + "\n")
        for label, row in zip(df.index, df.values.tolist()):
            f.write(label + "," + ",".join(
                "" if v != v else repr(v) for v in row) + "\n")


def write_reference_format(
    path: str, seed: int = 0, cancer_type: Optional[str] = None, **kw
) -> None:
    """Write make_synthetic_tables(seed, **kw) in the reference's file
    layout: raw_{mrna,cnv,methylation}.csv, clinical.pkl (the dict form),
    kegg.csv, pathways.txt, pathways.pkl and grn_edges.tsv (TF, target,
    importance).  With cancer_type, the per-cohort files (omics, clinical,
    edges) go under path/<cancer_type>/ and the shared ones stay in path,
    the layout the train CLI's --data-dir resolves."""
    omics, clinical, kegg, pathways, edges, edge_attrs = make_synthetic_tables(
        seed=seed, **kw
    )
    own = os.path.join(path, cancer_type) if cancer_type else path
    os.makedirs(own, exist_ok=True)
    for name in ("mrna", "cnv", "methylation"):
        _write_csv(os.path.join(own, f"raw_{name}.csv"), omics[name])
    with open(os.path.join(own, "clinical.pkl"), "wb") as f:
        pickle.dump(clinical, f)
    with open(os.path.join(path, "kegg.csv"), "w") as f:
        f.write("PathwayID,Symbol,Entrezid\n")
        for p, s, e in zip(kegg.pathway, kegg.symbol, kegg.entrez.tolist()):
            f.write(f"{p},{s},{e}\n")
    with open(os.path.join(path, "pathways.txt"), "w") as f:
        f.write("\n".join(pathways))
    with open(os.path.join(path, "pathways.pkl"), "wb") as f:
        pickle.dump(list(pathways), f)
    id2sym = {int(e): s for s, e in zip(kegg.symbol, kegg.entrez.tolist())}
    with open(os.path.join(own, "grn_edges.tsv"), "w") as f:
        f.write("TF\ttarget\timportance\n")
        for s, lst in edges.items():
            for (a, b), w in zip(lst, edge_attrs[s]):
                f.write(f"{id2sym[a]}\t{id2sym[b]}\t{w!r}\n")


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
