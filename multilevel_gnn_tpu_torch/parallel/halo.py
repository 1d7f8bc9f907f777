"""Boundary-only halo exchange (port of multilevel_gnn_tpu/parallel/halo.py:
HaloPartition :46-97, build_halo_partition :333-488, halo_gather_scatter
:491-636, pad_nodes_for :639-646).

Nodes are split into k blocks of Nl = ceil(N / k) rows; rank p owns rows
[p*Nl, (p+1)*Nl).  Each edge lives on its receiver's rank, interior edges
(sender owned there) first, then boundary edges, whose senders are read
from halo slots: rank q sends rank p the H-row block send_idx[q, p] of its
own rows in one all_to_all of (k, H, F).  The host arrays of
build_halo_partition are JAX's, array for array.

Each rank then builds its own plans (``HaloPartition.for_rank``): the
interior K1 csr / csc over its Nl rows (or, windowed, a K2 WindowPlan over
them, window ranges being ownership-local by construction), the boundary
K1 plans by receiver and by halo slot, and the send gather's
CSRPlan.gather.  JAX's per-shard statics must be uniform across shards
because shard_map runs one SPMD program, which is what _stack_segments,
_local_segments, _pad_winside, _stack_plans and the res_len / tres_len
second pass (:100-330, :458-470) are for; a rank of the port runs its own
program on its own plans, so none of them is ported.

halo_gather_scatter works on the rank's node block, node-major (Nl, ...):
the interior partial first, then the send gather (K1 as its backward), the
all_to_all, the boundary partial, and / deg for mean.  gather_scatter_halo
is ops/spmm.py's route for a graph carrying a rank's halo plans: the
replicated x's block (local_block), the exchange, and the blocks gathered
back (all_gather_rows).  The activations stay replicated between convs, so
the exchange saves no bytes yet: the all-gather carries what JAX's psum
did.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from multilevel_gnn_tpu_torch.core.device import resolve_device
from multilevel_gnn_tpu_torch.core.graph import Graph, _host
from multilevel_gnn_tpu_torch.ops import spmm
from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import CSRPlan
from multilevel_gnn_tpu_torch.parallel import comm


def _round_up(x, m):
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class HaloPartition:
    """Host-built halo metadata of one graph on k ranks (numpy).

    senders_ext: (k, E_l) int32 sender in the rank's extended space
        [0, Nl + k*H): local rows, then halo slot q*H + j for the j-th row
        received from rank q.
    receivers_loc: (k, E_l) int32 receiver in [0, Nl).
    edge_sel: (k, E_l) int32 the edge's position in the padded edge array
        (padding slots: num_padded_edges).
    edge_mask: (k, E_l) bool, False on padding.
    interior: (k, E_l) bool, True where the sender is owned locally
        (interior edges first).
    send_idx: (k, k, H) int32 local rows rank q sends rank p, at [q, p].
    deg: (k, Nl) float32 the whole graph's in-degree of the owned rows.
    windowed: for_rank builds a K2 plan for the interior."""

    senders_ext: np.ndarray
    receivers_loc: np.ndarray
    edge_sel: np.ndarray
    edge_mask: np.ndarray
    interior: np.ndarray
    send_idx: np.ndarray
    deg: np.ndarray
    k: int
    n_local: int
    halo: int
    n_edges_local: int
    n_nodes: int
    n_edges: int
    windowed: bool = False

    def for_rank(self, p: int, group=None, device=None,
                 graph: Optional[Graph] = None) -> "RankHalo":
        """Rank p's plans on device, CUDA unless the caller asks for the
        CPU (the interior, boundary and send-gather K1 plans; the interior
        K2 plan when windowed).  graph: the graph
        partitioned (or its shard-padded copy, whose real edges sit at the
        same places): its edge weights (edge_attr, gcn_coef) are selected
        for the rank's edges here, once, for gather_scatter_halo."""
        device = resolve_device(device)
        Nl, H, k = self.n_local, self.halo, self.k
        n = int(self.edge_mask[p].sum())
        s_ext = self.senders_ext[p, :n].astype(np.int64)
        r_loc = self.receivers_loc[p, :n].astype(np.int64)
        inner = self.interior[p, :n]
        eid = np.arange(n)
        i, b = eid[inner], eid[~inner]
        win = None
        if self.windowed and len(i):
            from multilevel_gnn_tpu_torch.ops.kernels.windowed import build_plan

            win = build_plan(s_ext, r_loc, Nl, mask=inner).to(device)
        send_flat = self.send_idx[p].reshape(-1).astype(np.int64)

        def t(a, dtype):
            return torch.as_tensor(np.array(a), dtype=dtype).to(device)

        sel = t(self.edge_sel[p, :n], torch.int64)

        def pick(w):
            if graph is None or w is None:
                return None
            w = torch.as_tensor(w)
            w = w[:, 0] if w.dim() == 2 else w
            return w.float().to(device).index_select(0, sel).contiguous()

        return RankHalo(
            group=group, rank=p, k=k, n_local=Nl, halo=H, n_nodes=self.n_nodes,
            edge_sel=sel,
            edge_attr=pick(graph.edge_attr if graph is not None else None),
            gcn_coef=pick(graph.gcn_coef if graph is not None else None),
            deg=t(self.deg[p], torch.float32),
            int_csr=CSRPlan.build(r_loc[i], s_ext[i], i, Nl).to(device),
            int_csc=CSRPlan.build(s_ext[i], r_loc[i], i, Nl).to(device),
            bnd_csr=CSRPlan.build(r_loc[b], s_ext[b] - Nl, b, Nl).to(device),
            bnd_csc=CSRPlan.build(s_ext[b] - Nl, r_loc[b], b, k * H).to(device),
            send_idx=t(send_flat, torch.int64),
            send_plan=CSRPlan.gather(send_flat, Nl).to(device),
            win=win, n_interior=int(len(i)), n_boundary=int(len(b)),
        )


@dataclasses.dataclass(frozen=True)
class RankHalo:
    """One rank's halo plans: int_csr / int_csc (interior edges, rows and
    columns in [0, Nl)), bnd_csr / bnd_csc (boundary edges, columns the
    k*H halo slots), send_idx / send_plan (the k*H rows it sends, and the
    gather's backward plan), win (the interior's K2 plan or None), deg
    (Nl,), edge_sel (the rank's edges' positions in the padded edge
    array; entry ids of every plan index it) and the graph's edge_attr and
    gcn_coef at those positions (None where not selected)."""

    group: Optional[object]
    rank: int
    k: int
    n_local: int
    halo: int
    n_nodes: int
    edge_sel: torch.Tensor
    edge_attr: Optional[torch.Tensor]
    gcn_coef: Optional[torch.Tensor]
    deg: torch.Tensor
    int_csr: CSRPlan
    int_csc: CSRPlan
    bnd_csr: CSRPlan
    bnd_csc: CSRPlan
    send_idx: torch.Tensor
    send_plan: CSRPlan
    win: Optional[object]
    n_interior: int
    n_boundary: int

    @property
    def n_edges(self) -> int:
        return self.n_interior + self.n_boundary


def build_halo_partition(graph: Graph, k: int, windowed: bool = False) -> HaloPartition:
    """Partition graph's real edges for k ranks, on the host
    (halo.py:333-456)."""
    send_all = _host(graph.senders)
    recv_all = _host(graph.receivers)
    mask = _host(graph.edge_mask).astype(bool)
    send, recv = send_all[mask].astype(np.int64), recv_all[mask].astype(np.int64)
    order = np.arange(len(send_all))[mask]
    N, E = graph.n_nodes, len(send)
    Nl = _round_up(N, k) // k
    owner_s, owner_r = send // Nl, recv // Nl

    halo_rows = {}
    H = 1
    for p in range(k):
        for q in range(k):
            if p == q:
                continue
            rows = np.unique(send[(owner_r == p) & (owner_s == q)])
            halo_rows[(q, p)] = rows
            H = max(H, len(rows))

    send_idx = np.zeros((k, k, H), np.int32)
    for (q, p), rows in halo_rows.items():
        send_idx[q, p, : len(rows)] = rows - q * Nl

    per_shard = []
    E_l = 1
    for p in range(k):
        mine = np.where(owner_r == p)[0]
        interior = mine[owner_s[mine] == p]
        boundary = mine[owner_s[mine] != p]
        s_ext = np.empty(len(mine), np.int64)
        s_ext[: len(interior)] = send[interior] - p * Nl
        bs, bq = send[boundary], owner_s[boundary]
        pos = np.empty(len(boundary), np.int64)
        for q in range(k):
            m = bq == q
            if m.any():
                pos[m] = np.searchsorted(halo_rows[(q, p)], bs[m]) + q * H
        s_ext[len(interior):] = Nl + pos
        r_loc = np.concatenate([recv[interior], recv[boundary]]) - p * Nl
        esel = np.concatenate([order[interior], order[boundary]])
        per_shard.append((s_ext, r_loc, esel, len(interior)))
        E_l = max(E_l, len(mine))

    senders_ext = np.zeros((k, E_l), np.int32)
    receivers_loc = np.zeros((k, E_l), np.int32)
    edge_sel = np.full((k, E_l), graph.num_padded_edges, np.int32)
    edge_mask = np.zeros((k, E_l), bool)
    interior_m = np.zeros((k, E_l), bool)
    for p, (s_ext, r_loc, esel, n_int) in enumerate(per_shard):
        n = len(s_ext)
        senders_ext[p, :n] = s_ext
        receivers_loc[p, :n] = r_loc
        edge_sel[p, :n] = esel
        edge_mask[p, :n] = True
        interior_m[p, :n_int] = True

    deg = np.zeros((k, Nl), np.float32)
    cnt = np.bincount(recv, minlength=k * Nl).astype(np.float32)
    for p in range(k):
        deg[p] = cnt[p * Nl:(p + 1) * Nl]

    return HaloPartition(
        senders_ext=senders_ext, receivers_loc=receivers_loc, edge_sel=edge_sel,
        edge_mask=edge_mask, interior=interior_m, send_idx=send_idx, deg=deg,
        k=k, n_local=Nl, halo=H, n_edges_local=E_l, n_nodes=N, n_edges=E,
        windowed=windowed,
    )


def halo_gather_scatter(
    x_block: torch.Tensor,
    hp: RankHalo,
    reduce: str = "sum",
    edge_weight: Optional[torch.Tensor] = None,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The rank's (Nl, ...) block of the aggregation over every edge whose
    receiver it owns; x_block: its (Nl, ...) rows of x, node-major.
    edge_weight: (n_edges,) weights of the rank's edges (edge_sel's order),
    or None for 1.  dtype: the SpMM data type (bf16 halves the exchange
    too); the result is float32."""
    if reduce not in ("sum", "add", "mean"):
        raise NotImplementedError(reduce)
    k, Nl, H = hp.k, hp.n_local, hp.halo
    shape = x_block.shape
    x2 = x_block.reshape(Nl, -1)
    if dtype is not None:
        x2 = x2.to(dtype)
    x2 = x2.contiguous()
    w = (edge_weight.float().contiguous() if edge_weight is not None
         else torch.ones(hp.n_edges, dtype=torch.float32, device=x2.device))
    # interior first: it needs no remote row
    if hp.win is not None:
        part = spmm._WindowedSpMM.apply(x2, w, hp.win, spmm._PLAIN)
    else:
        part = spmm._ComposedSpMM.apply(x2, w, hp.int_csr, hp.int_csc, None, spmm._PLAIN)
    send = spmm.gather_rows(x2, hp.send_idx, hp.send_plan)
    F = send.shape[1]
    halo_rows = comm.all_to_all(send.reshape(k, H, F), hp.group).reshape(k * H, F)
    part = part + spmm._ComposedSpMM.apply(halo_rows, w, hp.bnd_csr, hp.bnd_csc, None,
                                           spmm._PLAIN)
    if reduce == "mean":
        part = part / torch.clamp(hp.deg, min=1.0)[:, None]
    return part.reshape(shape)


def pad_nodes_for(x: torch.Tensor, hp) -> torch.Tensor:
    """Zero-pad the node axis (dim 0) of a node-major x to k * n_local."""
    pad = hp.k * hp.n_local - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def gather_scatter_halo(x, graph: Graph, reduce: str, edge_weight=None, dtype=None):
    """spmm.gather_scatter (sum / add / mean) of a replicated node-major x
    over a rank's graph carrying its halo plans: its block of x, the
    exchange, and the blocks gathered back over the model group; float32
    (N, ...).  edge_weight: None or the rank's graph's own edge_attr or
    gcn_coef, whose values at the rank's halo edges the plans carry (a
    halo edge lies in another rank's block of the edge array)."""
    hp: RankHalo = graph.halo
    if edge_weight is None:
        w = None
    elif edge_weight is graph.edge_attr and hp.edge_attr is not None:
        w = hp.edge_attr
    elif edge_weight is graph.gcn_coef and hp.gcn_coef is not None:
        w = hp.gcn_coef
    else:
        raise NotImplementedError(
            "the halo form weights edges by the graph's edge_attr or gcn_coef, "
            "selected when the rank's plans are built (HaloPartition.for_rank)")
    shape = x.shape
    x2 = pad_nodes_for(x.reshape(shape[0], -1), hp)
    xb = comm.local_block(x2, hp.group, hp.n_local)
    out = halo_gather_scatter(xb, hp, reduce, w, dtype)
    out = comm.all_gather_rows(out, hp.group)[: shape[0]]
    return out.reshape(shape)
