"""Batch and per-fold context (port of multilevel_gnn_tpu/core/batch.py:22-111)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from multilevel_gnn_tpu_torch.core.device import resolve_device
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import CSRPlan


@dataclasses.dataclass(frozen=True)
class Batch:
    """One batch of patients on the shared fold topology.

    x: (B, NODES) float32 omics value per node slot (gene-major, omics
    interleaved), or (B, N, omics) per gene and pathway node for the
    gene-level models (DeeperGCN).  y: (B, 2) targets (col 0 = high
    risk).  age: (B,).  sample_mask: (B,) bool, False on padding rows of a
    ragged last batch.  raw_data: the models' side channel or None
    (DeeperGCN's (B, P, 3 * pca_dim) pathway node attrs)."""

    x: torch.Tensor
    y: torch.Tensor
    age: torch.Tensor
    sample_mask: torch.Tensor
    raw_data: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class FoldContext:
    """Per-fold constants shared by every batch.

    graph: fold topology on the device.  gene_pca_match: (G,) node slot per
    PCA row, -1 = missing.  pca_rows: (G,) the same with -1 resolved to the
    last node slot on the host (torch negative-index meaning; index_select
    takes no negative index).  raw_indice: (G,) pathway-slot id per PCA
    row.  info_mask: (G, 1) float32 MI mask.  reorder_idxs: (P,) pathway
    display permutation.  pca_gather: the gather_rows backward plan over
    pca_rows (K1: rows = node slots, columns = PCA rows).  pca_seed:
    optional (G, pca_dim) float32 PCA-seeded initial value of the
    learnable PCA params (init_with_pca).  graph2: edge_type 'merge''s
    secondary graph (Cohort.merge_graph2) or None.  edge_ids: (E,) int64
    edge-id table row per edge slot (the graph's last edge-attr column,
    clipped to the table) and edge_id_gather, its lookup's backward plan
    (CSRPlan.gather over the table's rows), for DeeperGCN's one-hot edge
    encoder; None elsewhere.  pathway_adj: (P, P) float32 pathway
    correlation + I of the fold's PCA (Cohort.fold), the DiffPool head's
    adjacency (batch.py:75)."""

    graph: Graph
    gene_pca_match: torch.Tensor
    pca_rows: torch.Tensor
    raw_indice: torch.Tensor
    info_mask: torch.Tensor
    reorder_idxs: torch.Tensor
    pca_gather: CSRPlan
    pca_seed: Optional[torch.Tensor] = None
    graph2: Optional[Graph] = None
    edge_ids: Optional[torch.Tensor] = None
    edge_id_gather: Optional[CSRPlan] = None
    pathway_adj: Optional[torch.Tensor] = None

    @property
    def num_pca_rows(self) -> int:
        return int(self.gene_pca_match.shape[0])

    @property
    def device(self) -> torch.device:
        return self.gene_pca_match.device


def make_fold_context(
    graph: Graph,
    gene_pca_match: np.ndarray,
    raw_indice: np.ndarray,
    info_mask: Optional[np.ndarray] = None,
    reorder_idxs: Optional[np.ndarray] = None,
    pca_seed: Optional[np.ndarray] = None,
    n_pathways: int = 146,
    device: Union[str, torch.device] = "cuda",
    edge_vocab: Optional[int] = None,
) -> FoldContext:
    """Fold context on ``device`` (batch.py:82), with the gather_rows
    backward plan built once per fold.  graph must already be on that
    device (Graph.with_sorted_meta).  edge_vocab: the edge-id table's row
    count; given, the edge ids (int(last edge-attr column) clipped to
    [0, edge_vocab), deepergcn.py:158-170) and their lookup plan are
    built."""
    dev = resolve_device(device)
    g = np.asarray(gene_pca_match, np.int64)
    if info_mask is None:
        info_mask = np.ones((len(g), 1), np.float32)
    info_mask = np.asarray(info_mask, np.float32).reshape(len(g), 1)
    if reorder_idxs is None:
        reorder_idxs = np.arange(n_pathways)
    resolved = np.where(g >= 0, g, graph.n_nodes + g)
    if len(resolved) and (resolved.min() < 0 or resolved.max() >= graph.n_nodes):
        raise ValueError("gene_pca_match out of range")

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype).to(dev)

    edge_ids = edge_id_gather = None
    if edge_vocab is not None:
        attr = graph.edge_attr
        attr = attr.cpu().numpy() if isinstance(attr, torch.Tensor) else np.asarray(attr)
        ids = np.clip(attr[:, -1].astype(np.int32), 0, edge_vocab - 1)
        edge_ids = t(ids, torch.int64)
        edge_id_gather = CSRPlan.gather(ids, edge_vocab).to(dev)

    return FoldContext(
        graph=graph,
        gene_pca_match=t(g, torch.int64),
        pca_rows=t(resolved, torch.int64),
        raw_indice=t(np.asarray(raw_indice), torch.int64),
        info_mask=t(info_mask, torch.float32),
        reorder_idxs=t(np.asarray(reorder_idxs), torch.int64),
        pca_gather=CSRPlan.gather(resolved, graph.n_nodes).to(dev),
        pca_seed=(
            t(np.asarray(pca_seed, np.float32), torch.float32)
            if pca_seed is not None
            else None
        ),
        edge_ids=edge_ids,
        edge_id_gather=edge_id_gather,
    )
