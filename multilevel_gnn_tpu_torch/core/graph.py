"""Static-topology graph container (port of multilevel_gnn_tpu/core/graph.py).

Per fold the topology is identical across patients, so it is stored once:
a destination-sorted, optionally padded edge list.  The build steps
(from_edges, with_self_loops, pad_edges_to, with_window_meta) run on host
numpy arrays; with_sorted_meta, the last step, builds the kernels' plans
and moves everything to the target device as torch tensors.

Padding edges point at node n_nodes-1 with mask False and attr 0; they are
dropped from every plan and from the degree.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from multilevel_gnn_tpu_torch.core.device import resolve_device

Array = Union[np.ndarray, torch.Tensor]


def _sort_by_dst(edge_index: np.ndarray, edge_attr: Optional[np.ndarray]):
    order = np.argsort(edge_index[1], kind="stable")
    edge_index = edge_index[:, order]
    edge_attr = edge_attr[order] if edge_attr is not None else None
    return edge_index, edge_attr


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclasses.dataclass(frozen=True)
class Graph:
    """A single static graph topology, destination-sorted, padded.

    senders / receivers: (E,) source / destination node per edge (receivers
    sorted).  edge_attr: (E, A) float32 or None.  edge_mask: (E,) bool,
    False on padding edges.  n_nodes / n_edges: real node / edge counts.
    csr: K1 plan over the real edges (receiver-sorted; K3 reads its rowptr
    and eid), csc: its transpose (sender-sorted, for the backward),
    src_gather / dst_gather: K1 plans whose rows are the senders /
    receivers and whose columns are the edge rows (the backward of the
    edge gathers x[senders] / x[receivers]), in_deg: (n_nodes,) float32
    real in-degree, winplan: K2 plan or None; all are set by
    with_sorted_meta / with_window_meta.  On a mesh (parallel/mesh.py:
    shard_ctx) a rank's graph holds its block of the edges, with shard its
    EdgeShard, and the halo form's per-rank plans in halo (parallel/
    halo.py); in_deg, gcn_self and the block's gcn_coef stay the whole
    graph's."""

    senders: Array
    receivers: Array
    edge_attr: Optional[Array]
    edge_mask: Array
    n_nodes: int
    n_edges: int
    csr: Optional[object] = None
    csc: Optional[object] = None
    src_gather: Optional[object] = None
    dst_gather: Optional[object] = None
    in_deg: Optional[torch.Tensor] = None
    gcn_coef: Optional[torch.Tensor] = None
    gcn_self: Optional[torch.Tensor] = None
    winplan: Optional[object] = None
    shard: Optional[object] = None
    halo: Optional[object] = None

    @staticmethod
    def from_edges(
        edge_index: np.ndarray,
        edge_attr: Optional[np.ndarray],
        n_nodes: int,
        pad_to: Optional[int] = None,
    ) -> "Graph":
        """Destination-sorted, optionally padded Graph (graph.py:64).
        Padding edges get senders/receivers = n_nodes - 1, edge_mask False
        and zero edge_attr."""
        edge_index = np.asarray(edge_index, dtype=np.int32)
        if edge_index.size == 0:
            edge_index = edge_index.reshape(2, 0)
        n_edges = edge_index.shape[1]
        if edge_attr is not None:
            edge_attr = np.asarray(edge_attr, dtype=np.float32)
            if edge_attr.ndim == 1:
                edge_attr = edge_attr[:, None]
        edge_index, edge_attr = _sort_by_dst(edge_index, edge_attr)
        pad_to = pad_to if pad_to is not None else n_edges
        if pad_to < n_edges:
            raise ValueError(f"pad_to={pad_to} < n_edges={n_edges}")
        pad = pad_to - n_edges
        mask = np.concatenate([np.ones(n_edges, bool), np.zeros(pad, bool)])
        if pad:
            pad_idx = np.full((2, pad), max(n_nodes - 1, 0), dtype=np.int32)
            edge_index = np.concatenate([edge_index, pad_idx], axis=1)
            if edge_attr is not None:
                edge_attr = np.concatenate(
                    [edge_attr, np.zeros((pad, edge_attr.shape[1]), np.float32)]
                )
        return Graph(
            senders=edge_index[0],
            receivers=edge_index[1],
            edge_attr=edge_attr,
            edge_mask=mask,
            n_nodes=int(n_nodes),
            n_edges=int(n_edges),
        )

    def _real_edges(self):
        m = _host(self.edge_mask)
        send, recv = _host(self.senders)[m], _host(self.receivers)[m]
        attr = _host(self.edge_attr)[m] if self.edge_attr is not None else None
        return send, recv, attr

    def with_self_loops(self, fill_value: float = 1.0) -> "Graph":
        """Remove existing self loops, then append one per node with attr
        fill_value (graph.py:112; PyG remove/add_self_loops)."""
        send, recv, attr = self._real_edges()
        keep = send != recv
        send, recv = send[keep], recv[keep]
        if attr is not None:
            attr = attr[keep]
        loop = np.arange(self.n_nodes, dtype=np.int32)
        send = np.concatenate([send, loop])
        recv = np.concatenate([recv, loop])
        if attr is not None:
            attr = np.concatenate(
                [attr, np.full((self.n_nodes, attr.shape[1]), fill_value, np.float32)]
            )
        return Graph.from_edges(np.stack([send, recv]), attr, self.n_nodes)

    def pad_edges_to(self, pad_to: int) -> "Graph":
        """Re-pad the real edges to pad_to slots (graph.py:156)."""
        send = _host(self.senders)[: self.n_edges]
        recv = _host(self.receivers)[: self.n_edges]
        attr = (
            _host(self.edge_attr)[: self.n_edges]
            if self.edge_attr is not None
            else None
        )
        return Graph.from_edges(
            np.stack([send, recv]), attr, self.n_nodes, pad_to=pad_to
        )

    @property
    def num_padded_edges(self) -> int:
        return int(self.senders.shape[0])

    def with_window_meta(
        self,
        perm_group: int = 1,
        Wb: int = 512,
        nwin: int = 2,
        min_frac: float = 0.5,
    ) -> "Graph":
        """Attach a windowed-SpMM plan (graph.py:201) when the topology is
        local enough; returns self unchanged when fewer than min_frac of
        the edges fit windows even after RCM.  Call before
        with_sorted_meta.  perm_group=3 permutes genes in the 3*gene+omics
        interleave, keeping cross-omics edges adjacent."""
        from multilevel_gnn_tpu_torch.ops.kernels import windowed as W

        send, recv = _host(self.senders), _host(self.receivers)
        mask = _host(self.edge_mask)
        perm, _, f_best = W.choose_node_perm(
            send[mask], recv[mask], self.n_nodes, Wb=Wb, nwin=nwin,
            group=perm_group,
        )
        if f_best < min_frac:
            return self
        plan = W.build_plan(
            send, recv, self.n_nodes, mask=mask, perm=perm, Wb=Wb, nwin=nwin
        )
        return dataclasses.replace(self, winplan=plan)

    def with_sorted_meta(self, device: Union[str, torch.device] = "cuda") -> "Graph":
        """Build the K1 plans over the real edges (receiver-sorted csr and
        its sender-sorted transpose csc, graph.py:190-191's SortedSegments
        pair; src_gather and dst_gather, the same row partitions over edge
        rows, which gather_rows's backward uses with them, spmm.py:364-378)
        and the real in-degree, and move the graph (and any window plan) to
        ``device``."""
        from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import CSRPlan

        dev = resolve_device(device)
        send, recv = _host(self.senders), _host(self.receivers)
        mask = _host(self.edge_mask)
        ok = mask & (recv >= 0) & (recv < self.n_nodes) & (send >= 0) & (
            send < self.n_nodes
        )
        eid = np.flatnonzero(ok)
        csr = CSRPlan.build(recv[eid], send[eid], eid, self.n_nodes)
        csc = CSRPlan.build(send[eid], recv[eid], eid, self.n_nodes)
        src_gather = CSRPlan.build(send[eid], eid, eid, self.n_nodes)
        dst_gather = CSRPlan.build(recv[eid], eid, eid, self.n_nodes)
        deg = np.bincount(recv[mask], minlength=self.n_nodes).astype(np.float32)
        # GCNConv's symmetric normalisation of A + I (conv.py:335-337), once
        # per graph: it depends on the topology only
        dinv = torch.rsqrt(torch.from_numpy(deg) + 1.0)
        coef = torch.zeros(len(send), dtype=torch.float32)
        s_real = torch.from_numpy(send[eid]).long()
        r_real = torch.from_numpy(recv[eid]).long()
        coef[torch.from_numpy(eid)] = dinv[s_real] * dinv[r_real]

        def t(a, dtype):
            return torch.as_tensor(np.array(a), dtype=dtype).to(dev)

        return dataclasses.replace(
            self,
            senders=t(send, torch.int64),
            receivers=t(recv, torch.int64),
            edge_attr=(
                t(_host(self.edge_attr), torch.float32)
                if self.edge_attr is not None
                else None
            ),
            edge_mask=t(mask, torch.bool),
            csr=csr.to(dev),
            csc=csc.to(dev),
            src_gather=src_gather.to(dev),
            dst_gather=dst_gather.to(dev),
            in_deg=t(deg, torch.float32),
            gcn_coef=coef.to(dev),
            gcn_self=(dinv * dinv).to(dev),
            winplan=self.winplan.to(dev) if self.winplan is not None else None,
        )

    def in_degree(self) -> torch.Tensor:
        """In-degree per node counting only real edges (graph.py:232)."""
        if self.in_deg is not None:
            return self.in_deg
        recv = torch.as_tensor(_host(self.receivers), dtype=torch.int64)
        mask = torch.as_tensor(_host(self.edge_mask), dtype=torch.bool)
        return torch.bincount(recv[mask], minlength=self.n_nodes).float()


# a graph's per-unit tensors: each unit of a stacked graph has its own
UNIT_FIELDS = ("senders", "receivers", "edge_attr", "edge_mask", "in_deg",
               "gcn_coef", "gcn_self")


@dataclasses.dataclass(frozen=True)
class StackedGraph:
    """U graphs over one node count, as the fold-parallel step runs them.

    view: a Graph whose plans (csr, csc, src_gather, dst_gather, winplan)
    are block-diagonal over the U units (unit u's node rows at u * N,
    its edge rows at u * E), so each kernel launch serves every unit;
    its UNIT_FIELDS are unit 0's.  fields: those tensors of every unit,
    (U, ...), each unit's edges padded to E = the largest edge count
    (padding edges masked out, as Graph pads).  Inside the vmapped step,
    unit(fields) is a unit's Graph: its tensors are the batched ones and
    its plans the stacked ones, which the ops in ops/spmm.py read with
    the unit axis folded into the rows."""

    view: Graph
    fields: Dict[str, torch.Tensor]

    def unit(self, fields: Dict[str, torch.Tensor]) -> Graph:
        return dataclasses.replace(self.view, **fields)


def _pad_rows(t: torch.Tensor, n: int, value) -> torch.Tensor:
    if t.shape[0] == n:
        return t
    pad = t.new_full((n - t.shape[0],) + tuple(t.shape[1:]), value)
    return torch.cat([t, pad])


def stack_graphs(graphs: Sequence[Graph], names: Optional[Sequence[str]] = None
                 ) -> StackedGraph:
    """Stack U graphs built by with_sorted_meta on one device into one
    block-diagonal StackedGraph.  They must share the node count, the edge
    attrs' width and the aggregation path: a windowed graph does not stack
    with a composed one (ValueError naming the unit), as the windowed and
    composed paths sum in different orders."""
    names = list(names) if names is not None else [f"unit {u}" for u in range(len(graphs))]
    g0 = graphs[0]
    for name, g in zip(names, graphs):
        if g.csr is None:
            raise ValueError(f"{name}: the graph needs with_sorted_meta() first")
        if g.n_nodes != g0.n_nodes:
            raise ValueError(f"{name} has {g.n_nodes} nodes, {names[0]} {g0.n_nodes}: "
                             "fold-parallel units need one node count")
        if (g.winplan is None) != (g0.winplan is None):
            raise ValueError(
                f"{name}'s graph is {'composed' if g.winplan is None else 'windowed'} and "
                f"{names[0]}'s is not: fold-parallel does not mix the windowed and "
                "composed paths (windowed_min_edges splits these folds)")
        a, a0 = g.edge_attr, g0.edge_attr
        if (a is None) != (a0 is None) or (a is not None and a.shape[1:] != a0.shape[1:]):
            raise ValueError(f"{name}'s edge attrs differ in width from {names[0]}'s")
    N = g0.n_nodes
    E = max(g.num_padded_edges for g in graphs)
    pad_value = {"senders": max(N - 1, 0), "receivers": max(N - 1, 0), "edge_attr": 0.0,
                 "edge_mask": False, "gcn_coef": 0.0}
    fields = {}
    for f in UNIT_FIELDS:
        if getattr(g0, f) is None:
            continue
        parts = [getattr(g, f) for g in graphs]
        if f in pad_value:
            parts = [_pad_rows(t, E, pad_value[f]) for t in parts]
        fields[f] = torch.stack(parts)
    from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import CSRPlan
    from multilevel_gnn_tpu_torch.ops.kernels.windowed import WindowPlan

    def plans(attr, col_stride):
        return CSRPlan.stack([getattr(g, attr) for g in graphs], col_stride, E)

    view = dataclasses.replace(
        g0, **{f: t[0] for f, t in fields.items()},
        n_edges=max(g.n_edges for g in graphs),
        csr=plans("csr", N), csc=plans("csc", N),
        src_gather=plans("src_gather", E), dst_gather=plans("dst_gather", E),
        winplan=(WindowPlan.stack([g.winplan for g in graphs], E)
                 if g0.winplan is not None else None),
    )
    return StackedGraph(view=view, fields=fields)
