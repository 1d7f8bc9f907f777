"""Batch and per-fold context (port of multilevel_gnn_tpu/core/batch.py:22-111)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from multilevel_gnn_tpu_torch.core.device import resolve_device
from multilevel_gnn_tpu_torch.core.graph import Graph, StackedGraph, stack_graphs
from multilevel_gnn_tpu_torch.ops.kernels.pathway import SlotPlan
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
    adjacency (batch.py:75).  data: on a data rank of a mesh, the rank's
    parallel/comm.py:DataShard (set by parallel/mesh.py:DataParallel for
    one forward), which the batch-coupled statistics read; None
    elsewhere.  slot_plan: the pathway contraction's SlotPlan over
    raw_indice and the 3 * n_pathways slots, built once a fold (a stacked
    context's view keeps unit 0's, which the vmapped step does not read);
    None where the context was made without it, and then the contraction
    builds one a call."""

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
    data: Optional[object] = None
    slot_plan: Optional[SlotPlan] = None

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
    backward plan and the pathway contraction's slot plan built once per
    fold.  graph must already be on that
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
        slot_plan=SlotPlan.build(raw_indice, 3 * n_pathways).to(dev),
    )


# a context's per-unit tensors (FoldContext fields) in the fold-parallel step;
# OPTIONAL_UNIT_FIELDS are stacked where the contexts carry them
UNIT_CTX_FIELDS = ("gene_pca_match", "pca_rows", "raw_indice", "info_mask",
                   "reorder_idxs")
OPTIONAL_UNIT_FIELDS = ("edge_ids", "pathway_adj")


@dataclasses.dataclass(frozen=True)
class StackedContext:
    """U fold contexts over one fold shape, as the fold-parallel step runs
    them (train/fold_parallel.py).

    view: a FoldContext whose plans are block-diagonal over the units (the
    graph's, graph2's, pca_gather and edge_id_gather: unit u's node rows
    at u * N, its PCA rows at u * G, its edge-id table rows at u * V and
    its edge slots at u * E) and whose per-unit fields are unit 0's.
    fields: UNIT_CTX_FIELDS and the OPTIONAL_UNIT_FIELDS the contexts
    carry, of every unit, (U, ...); graphs: the stacked graph and graph2
    (or None).  Inside the vmapped step, unit(fields, graph_fields,
    graph2_fields) is a unit's FoldContext."""

    view: FoldContext
    fields: Dict[str, torch.Tensor]
    graph: StackedGraph
    graph2: Optional[StackedGraph]

    def unit(self, fields, graph_fields, graph2_fields=None) -> FoldContext:
        g2 = self.graph2.unit(graph2_fields) if self.graph2 is not None else None
        return dataclasses.replace(self.view, graph=self.graph.unit(graph_fields),
                                   graph2=g2, **fields)

    def inputs(self) -> tuple:
        """The batched tensors unit() takes, for torch.vmap's in_dims 0."""
        g2 = self.graph2.fields if self.graph2 is not None else {}
        return self.fields, self.graph.fields, g2


def stack_contexts(ctxs: Sequence[FoldContext], names: Optional[Sequence[str]] = None
                   ) -> StackedContext:
    """Stack U fold contexts on one device (stack_graphs for their graphs).
    They must match in shape: node count, PCA rows, the aggregation path,
    the edge-id table's rows and which optional fields they carry; a
    context that does not raises ValueError naming its unit.  DeeperGCN's
    edge ids are padded, as the graph's edges are, to the stacked edge
    stride E (padding slots take table row 0 and get no gradient: their
    messages are masked out), and their lookup plans stacked over U * V
    table rows and U * E edge slots, so the lookup's backward is one K1
    launch for all units; DiffPool's pathway_adj (P, P) is each unit's
    fold's.  pca_seed is not stacked: each unit's model is seeded before
    its parameters are."""
    names = list(names) if names is not None else [f"unit {u}" for u in range(len(ctxs))]
    c0 = ctxs[0]
    for name, c in zip(names, ctxs):
        if c.num_pca_rows != c0.num_pca_rows:
            raise ValueError(f"{name} has {c.num_pca_rows} PCA rows, {names[0]} "
                             f"{c0.num_pca_rows}: fold-parallel units need one count")
        for f in OPTIONAL_UNIT_FIELDS:
            if (getattr(c, f) is None) != (getattr(c0, f) is None):
                raise ValueError(f"{name} and {names[0]} differ in carrying {f}")
    graph = stack_graphs([c.graph for c in ctxs], names)
    graph2 = (stack_graphs([c.graph2 for c in ctxs], names)
              if c0.graph2 is not None else None)
    E = int(graph.fields["senders"].shape[1])
    fields = {f: torch.stack([getattr(c, f) for c in ctxs]) for f in UNIT_CTX_FIELDS}
    edge_id_gather = None
    if c0.edge_ids is not None:
        fields["edge_ids"] = torch.stack([
            torch.cat([c.edge_ids, c.edge_ids.new_zeros(E - c.edge_ids.shape[0])])
            for c in ctxs])
        edge_id_gather = CSRPlan.stack([c.edge_id_gather for c in ctxs], E, E)
    if c0.pathway_adj is not None:
        fields["pathway_adj"] = torch.stack([c.pathway_adj for c in ctxs])
    G = c0.num_pca_rows
    view = dataclasses.replace(
        c0, graph=graph.view, graph2=graph2.view if graph2 is not None else None,
        pca_gather=CSRPlan.stack([c.pca_gather for c in ctxs], G, G),
        edge_id_gather=edge_id_gather, pca_seed=None,
    )
    return StackedContext(view=view, fields=fields, graph=graph, graph2=graph2)
