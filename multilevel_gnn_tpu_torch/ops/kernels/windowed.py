"""K2: windowed (locality-blocked) SpMM, forward and transpose sides.

Counterpart of multilevel_gnn_tpu/ops/pallas/windowed.py: the host plan
(``choose_node_perm`` :297, ``_best_window`` :141, ``_build_side`` :160,
``build_plan`` :371), the kernel binding (``windowed_tile_spmm``, for
``windowed_exec`` :574, either side) and the composed product
(``windowed_spmm``, for ``windowed_spmm_2d`` :711 and its backward
``_wspmm_bwd`` :755).

The window choice, the node permutation and the in-window / residual split
are the JAX package's, unchanged: each 128-row destination tile (in the
permuted order) picks the aligned window of ``Wb * nwin`` source rows that
holds most of its edges; the other edges are the residual, summed by K1.
The layout differs: instead of te-edge chunks for one-hot matmuls, the
plan lists, per tile, the non-empty 128-row source sub-blocks of its
window as blocks of at most ``ENT_CAP`` distinct (dst, src) entries (a
denser sub-block is split at destination-row boundaries), per block the
entry range of each destination row, and per entry its edges (grouped so
one thread sums each entry in a fixed order).  The transpose side is the
same layout built with senders and receivers swapped, over the forward's
in-window edges; the kernel is the same.

bf16 data rounds each edge weight to bf16, sums an entry's weights in f32
in plan order and rounds the sum to bf16, as the TPU kernel's weighted
one-hot and adjacency cast do (windowed.py:523-533, :561); the residual
plans' K1 rounds its weights the same way.  The kernel is the
``torch.library`` op ``mgtpu::windowed_tile_spmm``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from multilevel_gnn_tpu_torch.ops.kernels.build import Kernel, register, stream_handle
from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import (
    CSRPlan,
    segment_spmm_csr,
    segment_spmm_csr_plain,
)
from multilevel_gnn_tpu_torch.ops.segment import segment_sum
from multilevel_gnn_tpu_torch.utils.profiling import span

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = register(
    Kernel(
        name="windowed_tile_spmm",
        source="windowed_tile_spmm.cu",
        symbol="windowed_tile_spmm",
        # tile_blk_ptr, blk_src, blk_ent_ptr, blk_row_ptr, ent_pos,
        # ent_edge_ptr, edge_eid, w, row_of, ent_pv, x, out, n_tiles, n_ent,
        # N, F, is_bf16, vector, stream
        argtypes=[_P] * 12 + [_I] * 6 + [_P],
        replaces="multilevel_gnn_tpu/ops/pallas/windowed.py:574",
    )
)

TN = 128  # destination rows per tile (the kernel's TN)
SB = 128  # source rows per sub-block (the kernel's SB)
ENT_CAP = 1024  # entries per block (the kernel's ENT_CAP)
RP = 132  # row pointers per block, TN + 1 padded to 16 bytes (the kernel's RP)


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _best_window(srcs: np.ndarray, Wb: int, nwin: int, n_row_blocks: int):
    """Aligned window (start block k) maximizing in-window edge count
    (windowed.py:141, unchanged)."""
    NW = Wb * nwin
    if len(srcs) == 0:
        return 0, np.zeros(0, bool)
    cand = np.unique(srcs // Wb)
    cand = np.unique(np.concatenate([cand, np.maximum(cand - (nwin - 1), 0)]))
    cand = cand[cand <= max(n_row_blocks - nwin, 0)]
    if len(cand) == 0:
        cand = np.array([0])
    best_k, best_cnt, best_mask = 0, -1, None
    for k in cand:
        m = (srcs >= k * Wb) & (srcs < k * Wb + NW)
        c = int(m.sum())
        if c > best_cnt:
            best_k, best_cnt, best_mask = int(k), c, m
    return best_k, best_mask


def choose_node_perm(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    Wb: int = 512,
    nwin: int = 2,
    tn: int = 128,
    group: int = 1,
    hub_degree_pct: float = 99.0,
) -> Tuple[Optional[np.ndarray], float, float]:
    """Node relabeling that maximizes the in-window edge fraction
    (windowed.py:297, unchanged): identity, or reverse Cuthill-McKee on the
    graph without hub nodes, in groups of ``group`` slots.  Returns
    (perm old->new or None, frac_identity, frac_best)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    def frac(s, d):
        total, ok = len(s), 0
        if total == 0:
            return 1.0
        tiles = d // tn
        n_blocks = _round_up(num_nodes, Wb) // Wb + nwin
        order = np.argsort(tiles, kind="stable")
        s = s[order]
        t_sorted = tiles[order]
        bounds = np.searchsorted(
            t_sorted, np.arange(_round_up(num_nodes, tn) // tn + 1)
        )
        for t in range(len(bounds) - 1):
            ss = s[bounds[t] : bounds[t + 1]]
            if len(ss):
                _, m = _best_window(ss, Wb, nwin, n_blocks)
                ok += int(m.sum())
        return ok / total

    f_id = frac(src, dst)
    if f_id > 0.97:
        return None, f_id, f_id

    g_src, g_dst = src // group, dst // group
    n_g = _round_up(num_nodes, group) // group
    deg = np.bincount(np.concatenate([g_src, g_dst]), minlength=n_g)
    thresh = np.percentile(deg[deg > 0], hub_degree_pct) if (deg > 0).any() else 0
    hub = deg > max(thresh, 1)
    keep = ~(hub[g_src] | hub[g_dst])
    ones = np.ones(int(keep.sum()), np.float32)
    adj = csr_matrix((ones, (g_src[keep], g_dst[keep])), shape=(n_g, n_g))
    gperm = np.asarray(
        reverse_cuthill_mckee((adj + adj.T).tocsr(), symmetric_mode=True)
    )
    g_rank = np.empty(n_g, np.int64)
    g_rank[gperm] = np.arange(n_g)
    perm = (g_rank[np.arange(num_nodes) // group] * group
            + np.arange(num_nodes) % group)
    f_rcm = frac(perm[src], perm[dst])
    if f_rcm > f_id + 0.02:
        return perm.astype(np.int32), f_id, f_rcm
    return None, f_id, max(f_id, f_rcm)


def _split_blocks(sub_start: np.ndarray, ent_row: np.ndarray, n_ent: int):
    """Block starts: each non-empty sub-block (entries sub_start[i] ..
    sub_start[i+1]), cut at destination-row boundaries into blocks of at
    most ENT_CAP entries.  A row has at most SB entries in a sub-block
    (its entries are distinct sources), so every cut makes progress."""
    ends = np.append(sub_start[1:], n_ent)
    starts = []
    for a, b in zip(sub_start.tolist(), ends.tolist()):
        cur = a
        while b - cur > ENT_CAP:
            # the start of the row that holds the first entry past the cap
            cut = a + int(np.searchsorted(ent_row[a:b], ent_row[cur + ENT_CAP]))
            starts.append(cur)
            cur = cut
        starts.append(cur)
    return np.asarray(starts, np.int64)


def _build_side(
    src: np.ndarray,
    dst: np.ndarray,
    edge_id: np.ndarray,
    num_nodes: int,
    Wb: int,
    nwin: int,
    n_row_blocks: int,
):
    """Window choice per destination tile (windowed.py:160's selection,
    unchanged) and the sub-block/entry layout of the in-window edges.
    src/dst are in the plan's (permuted) order.  Returns (layout dict,
    residual edge ids)."""
    n_tiles = max(_round_up(num_nodes, TN) // TN, 1)
    tiles = dst // TN
    order = np.argsort(tiles, kind="stable")
    src, dst, edge_id, tiles = src[order], dst[order], edge_id[order], tiles[order]
    bounds = np.searchsorted(tiles, np.arange(n_tiles + 1))

    keep = np.zeros(len(src), bool)
    for t in range(n_tiles):
        lo, hi = bounds[t], bounds[t + 1]
        if hi > lo:
            _, m = _best_window(src[lo:hi], Wb, nwin, n_row_blocks)
            keep[lo:hi] = m
    residual = edge_id[~keep]
    s, d, eid = src[keep], dst[keep], edge_id[keep]

    # entry key (tile, sub-block, dst, src); edges of one entry by edge id
    t, blk = d // TN, s // SB
    o = np.lexsort((eid, s, d, blk, t))
    s, d, eid, t, blk = s[o], d[o], eid[o], t[o], blk[o]
    n = len(s)
    new_ent = np.ones(n, bool)
    if n:
        new_ent[1:] = (
            (t[1:] != t[:-1]) | (blk[1:] != blk[:-1])
            | (d[1:] != d[:-1]) | (s[1:] != s[:-1])
        )
    ent_start = np.flatnonzero(new_ent)
    n_ent = len(ent_start)
    ent_t, ent_b = t[ent_start], blk[ent_start]
    ent_row = d[ent_start] % TN
    new_blk = np.ones(n_ent, bool)
    if n_ent:
        new_blk[1:] = (ent_t[1:] != ent_t[:-1]) | (ent_b[1:] != ent_b[:-1])
    blk_start = _split_blocks(np.flatnonzero(new_blk), ent_row, n_ent)
    n_blk = len(blk_start)
    # entry range of each destination row within each block: the entries
    # are sorted by (block, row), so one search over block * TN + row
    ent_blk = np.repeat(np.arange(n_blk), np.diff(np.append(blk_start, n_ent)))
    rows = np.arange(TN + 1)
    row_ptr = np.searchsorted(
        ent_blk * TN + ent_row, np.arange(n_blk)[:, None] * TN + rows[None, :]
    ) - blk_start[:, None]
    row_ptr = np.concatenate(
        [row_ptr, np.repeat(row_ptr[:, -1:], RP - TN - 1, axis=1)], axis=1
    )
    layout = dict(
        tile_blk_ptr=np.searchsorted(ent_t[blk_start], np.arange(n_tiles + 1)),
        blk_src=ent_b[blk_start] * SB,
        blk_ent_ptr=np.append(blk_start, n_ent),
        blk_row_ptr=row_ptr.reshape(n_blk, RP),
        ent_pos=ent_row * SB + (s[ent_start] % SB),
        ent_edge_ptr=np.append(ent_start, n),
        edge_eid=eid,
        ent_dst=d[ent_start],
        ent_src=s[ent_start],
        edge_ent=np.repeat(np.arange(n_ent), np.diff(np.append(ent_start, n))),
        n_tiles=n_tiles,
    )
    return layout, residual


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


@dataclasses.dataclass(frozen=True)
class WinSide:
    """The block/entry layout of one direction of the plan.

    Kernel arrays (int32): tile_blk_ptr (n_tiles+1), blk_src (n_blk),
    blk_ent_ptr (n_blk+1), blk_row_ptr (n_blk, RP: entry offsets of each
    destination row within its block, TN+1 used), ent_pos (n_ent,
    dst_local * SB + src_local), ent_edge_ptr (n_ent+1), edge_eid (n_in).
    ent_dst_orig / ent_src_orig (original row ids) and edge_ent serve the
    plain version.  On the forward side dst is the receiver and src the
    sender; on the transpose side the other way round."""

    tile_blk_ptr: torch.Tensor
    blk_src: torch.Tensor
    blk_ent_ptr: torch.Tensor
    blk_row_ptr: torch.Tensor
    ent_pos: torch.Tensor
    ent_edge_ptr: torch.Tensor
    edge_eid: torch.Tensor
    ent_dst_orig: torch.Tensor
    ent_src_orig: torch.Tensor
    edge_ent: torch.Tensor
    n_tiles: int

    @staticmethod
    def from_layout(lay: dict, orig) -> "WinSide":
        return WinSide(
            tile_blk_ptr=_t(lay["tile_blk_ptr"]),
            blk_src=_t(lay["blk_src"]),
            blk_ent_ptr=_t(lay["blk_ent_ptr"]),
            blk_row_ptr=_t(lay["blk_row_ptr"]),
            ent_pos=_t(lay["ent_pos"]),
            ent_edge_ptr=_t(lay["ent_edge_ptr"]),
            edge_eid=_t(lay["edge_eid"]),
            ent_dst_orig=_t(orig(lay["ent_dst"])),
            ent_src_orig=_t(orig(lay["ent_src"])),
            edge_ent=_t(lay["edge_ent"]),
            n_tiles=int(lay["n_tiles"]),
        )

    @property
    def n_blocks(self) -> int:
        return int(self.blk_src.shape[0])

    @property
    def n_entries(self) -> int:
        return int(self.ent_pos.shape[0])

    @property
    def n_in(self) -> int:
        return int(self.edge_eid.shape[0])

    @staticmethod
    def stack(sides, n_nodes: int, row_stride: int, n_edges: int) -> "WinSide":
        """Unit u's layout in a permuted space where its rows start at
        u * row_stride (a multiple of TN, so no tile or sub-block spans two
        units): tiles, blocks, entries and edges follow unit by unit, block
        sources shift by u * row_stride, original rows by u * n_nodes and
        edge ids by u * n_edges.  Row pointers within a block are relative
        and stay as they are."""
        def offs(counts):
            return np.cumsum([0] + list(counts)).tolist()

        blk = offs(s.n_blocks for s in sides)
        ent = offs(s.n_entries for s in sides)
        edge = offs(s.n_in for s in sides)

        def ptr(attr, base):
            dev = getattr(sides[0], attr).device
            parts = [getattr(s, attr)[:-1] + base[u] for u, s in enumerate(sides)]
            return torch.cat(parts + [torch.tensor([base[-1]], dtype=torch.int32,
                                                   device=dev)])

        def shifted(attr, stride):
            return torch.cat([(getattr(s, attr).long() + u * stride).int()
                              for u, s in enumerate(sides)])

        return WinSide(
            tile_blk_ptr=ptr("tile_blk_ptr", blk),
            blk_src=shifted("blk_src", row_stride),
            blk_ent_ptr=ptr("blk_ent_ptr", ent),
            blk_row_ptr=torch.cat([s.blk_row_ptr for s in sides]),
            ent_pos=torch.cat([s.ent_pos for s in sides]),
            ent_edge_ptr=ptr("ent_edge_ptr", edge),
            edge_eid=shifted("edge_eid", n_edges),
            ent_dst_orig=shifted("ent_dst_orig", n_nodes),
            ent_src_orig=shifted("ent_src_orig", n_nodes),
            edge_ent=torch.cat([(s.edge_ent.long() + ent[u]).int()
                                for u, s in enumerate(sides)]),
            n_tiles=sum(s.n_tiles for s in sides),
        )

    def to(self, device) -> "WinSide":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """Host-built windowed-SpMM plan for a static edge list.

    fwd: layout of the forward side (out[recv] += w * x[send]); bwd: the
    transpose side over exactly the forward's in-window edges (dx[send] +=
    w * g[recv]).  row_of: (N,) permuted row -> original row, or None for
    the identity order; both sides use it for reads and writes.  res: K1
    plan of the residual edges, rows = receivers, in the original order;
    res_csc: the same edges with rows = senders (its transpose); tres: the
    in-window edges whose transpose fell out of the transpose side's
    windows, rows = senders, columns = receivers, original order.  The
    kernels write in the original row order, so the JAX package's
    permuted-space tres plan becomes an original-order one here.  perm:
    old -> new node relabeling or None."""

    fwd: WinSide
    bwd: WinSide
    row_of: Optional[torch.Tensor]
    res: CSRPlan
    res_csc: CSRPlan
    tres: CSRPlan
    res_eid: np.ndarray
    tres_eid: np.ndarray
    perm: Optional[np.ndarray]
    num_nodes: int
    n_edges: int
    n_res: int
    n_tres: int
    in_window_frac: float
    Wb: int
    nwin: int

    @staticmethod
    def stack(plans, n_edges: int) -> "WindowPlan":
        """The block-diagonal plan of U units' plans over one node count,
        for (U * N, F) inputs and (U * n_edges,) weights (each unit's edges
        padded to n_edges).  Each unit keeps its own window choice, node
        permutation and residual split.  Its rows take the permuted rows
        u * Np .. u * Np + N - 1, Np = N rounded up to TN, so every tile
        and source sub-block holds one unit's rows; row_of maps them to
        u * N + the unit's original row and the Np - N rows between units
        to -1, which the kernel reads as zeros and never writes.  So each
        output row is the same sum, in the same order, as in its unit's own
        launch."""
        N = plans[0].num_nodes
        if any(p.num_nodes != N for p in plans):
            raise ValueError("stacked window plans need one node count")
        if any(p.n_edges > n_edges for p in plans):
            raise ValueError("a unit's plan has more edges than the stride")
        Np = max(_round_up(N, TN), TN)
        U = len(plans)
        if U * max(Np, n_edges) >= 2**31:
            raise ValueError("a stacked window plan's rows or edges overflow int32")
        dev = plans[0].fwd.tile_blk_ptr.device
        row_of = torch.full((U, Np), -1, dtype=torch.int32, device=dev)
        for u, p in enumerate(plans):
            own = (p.row_of.long() if p.row_of is not None
                   else torch.arange(N, device=dev))
            row_of[u, :N] = (own + u * N).int()

        def cat_eids(attr):
            return np.concatenate([getattr(p, attr) + u * n_edges
                                   for u, p in enumerate(plans)])

        return WindowPlan(
            fwd=WinSide.stack([p.fwd for p in plans], N, Np, n_edges),
            bwd=WinSide.stack([p.bwd for p in plans], N, Np, n_edges),
            row_of=row_of.reshape(-1),
            res=CSRPlan.stack([p.res for p in plans], N, n_edges),
            res_csc=CSRPlan.stack([p.res_csc for p in plans], N, n_edges),
            tres=CSRPlan.stack([p.tres for p in plans], N, n_edges),
            res_eid=cat_eids("res_eid"),
            tres_eid=cat_eids("tres_eid"),
            perm=None,
            num_nodes=U * N,
            n_edges=U * n_edges,
            n_res=sum(p.n_res for p in plans),
            n_tres=sum(p.n_tres for p in plans),
            in_window_frac=float(np.mean([p.in_window_frac for p in plans])),
            Wb=plans[0].Wb,
            nwin=plans[0].nwin,
        )

    def to(self, device) -> "WindowPlan":
        return dataclasses.replace(
            self,
            fwd=self.fwd.to(device),
            bwd=self.bwd.to(device),
            row_of=self.row_of.to(device) if self.row_of is not None else None,
            res=self.res.to(device),
            res_csc=self.res_csc.to(device),
            tres=self.tres.to(device),
        )


def build_plan(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    mask: Optional[np.ndarray] = None,
    perm: Optional[np.ndarray] = None,
    Wb: int = 512,
    nwin: int = 2,
) -> WindowPlan:
    """Build the windowed plan, forward and transpose sides (windowed.py:371).

    senders/receivers: (E,) host arrays in original node ids and original
    edge order (weights are indexed by original edge id).  mask False and
    out-of-range edges are dropped.  perm: optional old->new relabeling
    (choose_node_perm).  Wb must be a multiple of the 128-row sub-block."""
    if Wb % SB:
        raise ValueError(f"Wb={Wb} must be a multiple of {SB}")
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    E = len(senders)
    edge_id = np.arange(E, dtype=np.int64)
    if mask is not None:
        m = np.asarray(mask, bool)
        senders, receivers, edge_id = senders[m], receivers[m], edge_id[m]
    valid = (
        (senders >= 0) & (senders < num_nodes)
        & (receivers >= 0) & (receivers < num_nodes)
    )
    senders, receivers, edge_id = senders[valid], receivers[valid], edge_id[valid]
    if perm is not None:
        p = np.asarray(perm, np.int64)
        src, dst = p[senders], p[receivers]
    else:
        src, dst = senders, receivers

    n_row_blocks = _round_up(num_nodes, Wb) // Wb + nwin
    fwd, res = _build_side(src, dst, edge_id, num_nodes, Wb, nwin, n_row_blocks)
    # transpose side over exactly the in-window edges (windowed.py:417-424)
    in_win = ~np.isin(edge_id, res)
    bwd, tres = _build_side(
        dst[in_win], src[in_win], edge_id[in_win], num_nodes, Wb, nwin,
        n_row_blocks,
    )

    inv = None
    if perm is not None:
        inv = np.empty(num_nodes, np.int64)
        inv[np.asarray(perm, np.int64)] = np.arange(num_nodes)

    def orig(rows):
        return inv[rows] if inv is not None else rows

    def by_edge(ids):
        """Sorted edge ids and their positions in the kept edge arrays."""
        ids = np.sort(ids)
        return ids, np.searchsorted(edge_id, ids)

    res_sorted, pos = by_edge(res)
    tres_sorted, tpos = by_edge(tres)
    n_valid = len(edge_id)
    return WindowPlan(
        fwd=WinSide.from_layout(fwd, orig),
        bwd=WinSide.from_layout(bwd, orig),
        row_of=_t(inv) if inv is not None else None,
        # out[recv] += w * x[send]; its transpose dx[send] += w * g[recv]
        res=CSRPlan.build(receivers[pos], senders[pos], res_sorted, num_nodes),
        res_csc=CSRPlan.build(senders[pos], receivers[pos], res_sorted, num_nodes),
        tres=CSRPlan.build(
            senders[tpos], receivers[tpos], tres_sorted, num_nodes
        ),
        res_eid=res_sorted,
        tres_eid=tres_sorted,
        perm=np.asarray(perm, np.int32) if perm is not None else None,
        num_nodes=int(num_nodes),
        n_edges=E,
        n_res=int(len(res)),
        n_tres=int(len(tres)),
        in_window_frac=float(
            np.float32((n_valid - len(res)) / max(n_valid, 1))
        ),
        Wb=Wb,
        nwin=nwin,
    )


def _k2_plain(x, w, edge_eid, edge_ent, ent_src_orig, ent_dst_orig) -> torch.Tensor:
    we = w.index_select(0, edge_eid.long()).float()
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        we = we.to(torch.bfloat16).float()
    a = segment_sum(we, edge_ent, ent_src_orig.shape[0])
    if bf16:
        a = a.to(torch.bfloat16).float()
    msg = x.index_select(0, ent_src_orig.long()).float() * a[:, None]
    return segment_sum(msg, ent_dst_orig, x.shape[0])


def _side_args(plan: WindowPlan, transpose: bool):
    side = plan.bwd if transpose else plan.fwd
    return (side.tile_blk_ptr, side.blk_src, side.blk_ent_ptr, side.blk_row_ptr,
            side.ent_pos, side.ent_edge_ptr, side.edge_eid, plan.row_of,
            side.edge_ent, side.ent_src_orig, side.ent_dst_orig)


def windowed_tile_spmm_plain(
    x: torch.Tensor, w: torch.Tensor, plan: WindowPlan, transpose: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of windowed_tile_spmm: the same entry values
    (bf16 x: each weight rounded to bf16, the f32 sum rounded again), then
    the weighted row sums, in f32."""
    side = plan.bwd if transpose else plan.fwd
    return _k2_plain(x, w, side.edge_eid, side.edge_ent, side.ent_src_orig,
                     side.ent_dst_orig)


# K2 as the torch.library op mgtpu::windowed_tile_spmm, one side of the
# plan unpacked (the forward side, or the transpose side for the backward).
# The CPU kernel is the plain version, the CUDA kernel launches K2.
torch.library.define(
    "mgtpu::windowed_tile_spmm",
    "(Tensor x, Tensor w, Tensor tile_blk_ptr, Tensor blk_src, Tensor blk_ent_ptr, "
    "Tensor blk_row_ptr, Tensor ent_pos, Tensor ent_edge_ptr, Tensor edge_eid, "
    "Tensor? row_of, Tensor edge_ent, Tensor ent_src_orig, Tensor ent_dst_orig) -> Tensor")


@torch.library.impl("mgtpu::windowed_tile_spmm", "cpu")
def _(x, w, tile_blk_ptr, blk_src, blk_ent_ptr, blk_row_ptr, ent_pos,
      ent_edge_ptr, edge_eid, row_of, edge_ent, ent_src_orig, ent_dst_orig):
    return _k2_plain(x, w, edge_eid, edge_ent, ent_src_orig, ent_dst_orig)


# the feature columns of one block's slice (Slice<T>::FT in the .cu)
SLICE_COLS = {torch.bfloat16: 128, torch.float32: 64}


def launch_shape(x: torch.Tensor, out: torch.Tensor) -> Tuple[int, bool]:
    """(feature slices in the grid, whether the 16-byte vector path runs)
    of a K2 launch on x (N, F) into out."""
    F = x.shape[1]
    return (-(-F // SLICE_COLS[x.dtype]),
            F % 8 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)


@torch.library.impl("mgtpu::windowed_tile_spmm", "cuda")
def _(x, w, tile_blk_ptr, blk_src, blk_ent_ptr, blk_row_ptr, ent_pos,
      ent_edge_ptr, edge_eid, row_of, edge_ent, ent_src_orig, ent_dst_orig):
    N, F = x.shape
    out = torch.empty((N, F), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    # the kernel's N bounds the permuted rows, which row_of maps: a stacked
    # plan (WindowPlan.stack) has more permuted rows than x has rows, its
    # rows between units mapped to -1
    n_perm = row_of.shape[0] if row_of is not None else N
    n_ent = ent_pos.shape[0]
    ent_pv = torch.empty((n_ent, 2), dtype=torch.int32, device=x.device)
    _, vector = launch_shape(x, out)
    fn = KERNEL.fn()
    err = fn(
        tile_blk_ptr.data_ptr(), blk_src.data_ptr(), blk_ent_ptr.data_ptr(),
        blk_row_ptr.data_ptr(), ent_pos.data_ptr(), ent_edge_ptr.data_ptr(),
        edge_eid.data_ptr(), w.data_ptr(),
        row_of.data_ptr() if row_of is not None else None,
        ent_pv.data_ptr(), x.data_ptr(), out.data_ptr(),
        tile_blk_ptr.shape[0] - 1, n_ent, n_perm, F, int(x.dtype == torch.bfloat16),
        int(vector), stream_handle(x),
    )
    KERNEL.launches += 1
    KERNEL.check(err)
    return out


@torch.library.register_fake("mgtpu::windowed_tile_spmm")
def _(x, w, tile_blk_ptr, blk_src, blk_ent_ptr, blk_row_ptr, ent_pos,
      ent_edge_ptr, edge_eid, row_of, edge_ent, ent_src_orig, ent_dst_orig):
    return x.new_empty(x.shape, dtype=torch.float32)


windowed_tile_spmm_op = torch.ops.mgtpu.windowed_tile_spmm.default


def windowed_tile_spmm(
    x: torch.Tensor, w: torch.Tensor, plan: WindowPlan, transpose: bool = False
) -> torch.Tensor:
    """In-window part of the windowed SpMM: out (N, F) f32 in the original
    row order.  Forward side: out[n] = sum over n's in-window in-edges of
    w[e] * x[send(e)]; transpose side (transpose=True, the backward):
    out[n] = sum over n's in-window out-edges of w[e] * x[recv(e)].

    x: (N, F) bf16 or f32, original row order; w: (E,) f32 per original
    edge.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel."""
    side = plan.bwd if transpose else plan.fwd
    if x.dim() != 2 or not x.is_contiguous() or x.shape[0] != plan.num_nodes:
        raise ValueError("x must be a contiguous (num_nodes, F) tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x dtype {x.dtype} not supported (bf16 or f32)")
    if (
        w.dim() != 1 or w.dtype != torch.float32 or not w.is_contiguous()
        or w.shape[0] != plan.n_edges
    ):
        raise ValueError("w must be a contiguous (E,) float32 tensor")
    if w.device != x.device or side.tile_blk_ptr.device != x.device:
        raise ValueError("x, w and the plan must be on one device")
    with span("kernel.K2"):
        return windowed_tile_spmm_op(x, w, *_side_args(plan, transpose))


def _residual_plans(plan: WindowPlan, transpose: bool):
    """K1 plans added onto K2's output: the residual edges forward; the
    transpose residual and the residual's transpose backward
    (windowed.py:764-790, in that order)."""
    plans = (plan.tres, plan.res_csc) if transpose else (plan.res,)
    return [p for p in plans if p.nnz]


def windowed_spmm_plain(
    x: torch.Tensor, w: torch.Tensor, plan: WindowPlan, transpose: bool = False
) -> torch.Tensor:
    """windowed_spmm through both kernels' plain versions, on any device."""
    out = windowed_tile_spmm_plain(x, w, plan, transpose)
    for p in _residual_plans(plan, transpose):
        out = segment_spmm_csr_plain(x, w, p, out=out)
    return out


def windowed_spmm(
    x: torch.Tensor, w: torch.Tensor, plan: WindowPlan, transpose: bool = False
) -> torch.Tensor:
    """windowed_spmm_2d (windowed.py:711), (N, F) f32.  Forward: in-window
    edges through K2, residual edges added through K1.  transpose=True is
    its backward (windowed.py:755-790): K2 on the transpose side, then K1
    over the transpose residual and over the residual's transpose, added
    in place."""
    out = windowed_tile_spmm(x, w, plan, transpose)
    for p in _residual_plans(plan, transpose):
        segment_spmm_csr(x, w, p, out=out)
    return out
