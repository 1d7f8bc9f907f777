"""K1: weighted CSR segment-sum with the row gather fused in; K4: the
sorted segment-sum.

Counterpart of multilevel_gnn_tpu/ops/pallas/segment_sum.py: the host plans
(``CSRPlan`` and ``SortedPlan``, for ``SortedSegments.build`` :98-192), the
kernel bindings (``segment_spmm_csr``, for ``flat_segment_sum`` :497 plus
the row gather that feeds it; ``sorted_segment_sum`` and ``segment_sum_by``,
for the functions of those names :286, :384 and :585) and the kernels'
plain PyTorch versions.

The TPU layout pads each 128-row output tile's edges to whole te-chunks so
one-hot matmuls stream them; on Hopper a warp (or, for a long row, a
block) per output row reads the gathered rows directly, so the plan is a
plain receiver-sorted CSR: ``rowptr`` per output row, the source row
``col`` and original edge id ``eid`` per entry, and the lists of rows the
kernel visits.  Weights stay per original edge and are read through
``eid`` inside the kernel; with bf16 data each is rounded to bf16 first,
as ``flat_segment_sum`` does (segment_sum.py:481-490).

Each kernel is a ``torch.library`` op in namespace ``mgtpu`` whose
arguments are tensors and ints (the plans unpacked at the call): the CPU
kernel is the plain version, the CUDA kernel the hand-written one.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from multilevel_gnn_tpu_torch.ops.kernels.build import Kernel, register, stream_handle
from multilevel_gnn_tpu_torch.ops.segment import segment_sum

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = register(
    Kernel(
        name="segment_spmm_csr",
        source="segment_spmm_csr.cu",
        symbol="segment_spmm_csr",
        # rowptr, col, eid, w, items, long_rows, x, out, n_items, n_long, F,
        # is_bf16, accumulate, vector, stream
        argtypes=[_P] * 8 + [_I] * 6 + [_P],
        replaces="multilevel_gnn_tpu/ops/pallas/segment_sum.py:497",
    )
)

SORTED_KERNEL = register(
    Kernel(
        name="sorted_segment_sum",
        source="segment_sum_sorted.cu",
        symbol="sorted_segment_sum",
        # rowptr, perm, data, out, B, N, E, C, is_bf16, vector, stream
        argtypes=[_P] * 4 + [_I] * 6 + [_P],
        replaces="multilevel_gnn_tpu/ops/pallas/segment_sum.py:286",
    )
)


LONG_ROW = 64  # rows with more entries are summed by a whole block


@dataclasses.dataclass(frozen=True)
class CSRPlan:
    """Receiver-sorted CSR over a static edge set.

    rowptr: (n_rows + 1,) int32; entries of row n are rowptr[n]:rowptr[n+1].
    col:    (nnz,) int32 source row per entry.
    eid:    (nnz,) int32 original edge id per entry (indexes the weights).
    row:    (nnz,) int32 output row per entry (used by the plain version).
    items:  int32 rows a warp each sums: the rows with 1 .. LONG_ROW
            entries (n_busy of them), then the empty rows, which only the
            overwrite mode visits (to write zeros).
    long_rows: int32 rows with more than LONG_ROW entries, a block each.
    max_col / max_eid: largest col / eid (-1 when empty), checked against
    the inputs' sizes by the wrapper."""

    rowptr: torch.Tensor
    col: torch.Tensor
    eid: torch.Tensor
    row: torch.Tensor
    items: torch.Tensor
    long_rows: torch.Tensor
    n_rows: int
    n_busy: int
    max_col: int
    max_eid: int

    @staticmethod
    def build(
        rows: np.ndarray, cols: np.ndarray, eids: np.ndarray, n_rows: int
    ) -> "CSRPlan":
        """rows/cols/eids: (nnz,) host arrays of kept edges only (padding and
        masked edges already dropped).  Entries are stable-sorted by row, so
        each row sums its edges in their given order."""
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        eids = np.asarray(eids, np.int64)
        if not (len(rows) == len(cols) == len(eids)):
            raise ValueError("rows, cols and eids must have one length")
        if len(rows) and (rows.min() < 0 or rows.max() >= n_rows):
            raise ValueError("CSR row id out of range")
        if len(cols) and cols.min() < 0:
            raise ValueError("negative CSR column id")
        order = np.argsort(rows, kind="stable")
        rows, cols, eids = rows[order], cols[order], eids[order]
        rowptr = np.searchsorted(rows, np.arange(n_rows + 1), "left")
        lens = np.diff(rowptr)
        busy = np.flatnonzero((lens > 0) & (lens <= LONG_ROW))

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32))

        return CSRPlan(
            rowptr=t(rowptr),
            col=t(cols),
            eid=t(eids),
            row=t(rows),
            items=t(np.concatenate([busy, np.flatnonzero(lens == 0)])),
            long_rows=t(np.flatnonzero(lens > LONG_ROW)),
            n_rows=int(n_rows),
            n_busy=len(busy),
            max_col=int(cols.max()) if len(cols) else -1,
            max_eid=int(eids.max()) if len(eids) else -1,
        )

    @staticmethod
    def gather(idx: np.ndarray, n_rows: int) -> "CSRPlan":
        """The gather_rows backward plan: rows = the node slots idx points
        at, columns = the gathered rows (counterpart of the SortedSegments
        built over the resolved gene_pca_match, core/batch.py:110)."""
        idx = np.asarray(idx, np.int64)
        rows = np.arange(len(idx))
        return CSRPlan.build(idx, rows, rows, n_rows)

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def to(self, device) -> "CSRPlan":
        return dataclasses.replace(
            self,
            rowptr=self.rowptr.to(device),
            col=self.col.to(device),
            eid=self.eid.to(device),
            row=self.row.to(device),
            items=self.items.to(device),
            long_rows=self.long_rows.to(device),
        )


def _k1_plain(x, w, col, eid, row, n_rows: int) -> torch.Tensor:
    we = w.index_select(0, eid.long()).float()
    if x.dtype == torch.bfloat16:
        we = we.to(torch.bfloat16).float()
    msg = x.index_select(0, col.long()).float() * we[:, None]
    return segment_sum(msg, row, n_rows)


def segment_spmm_csr_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    plan: CSRPlan,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of segment_spmm_csr (same contract)."""
    res = _k1_plain(x, w, plan.col, plan.eid, plan.row, plan.n_rows)
    return res if out is None else out.add_(res)


def _check_inputs(x, w, plan, out):
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (rows, F) tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x dtype {x.dtype} not supported (bf16 or f32)")
    if w.dim() != 1 or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError("w must be a contiguous (E,) float32 tensor")
    if plan.max_col >= x.shape[0] or plan.max_eid >= w.shape[0]:
        raise ValueError("plan indexes past x rows or w entries")
    for t in (w, plan.rowptr, plan.col, plan.eid, plan.items):
        if t.device != x.device:
            raise ValueError("x, w and the plan must be on one device")
    if out is not None and (
        out.dtype != torch.float32
        or tuple(out.shape) != (plan.n_rows, x.shape[1])
        or not out.is_contiguous()
        or out.device != x.device
    ):
        raise ValueError("out must be a contiguous (n_rows, F) float32 tensor")


def _k1_launch(out, x, w, rowptr, col, eid, items, long_rows, n_items: int,
               accumulate: bool) -> None:
    """K1 on the card into out (n_rows, F) f32: overwrite the first n_items
    rows of items and every long row, or add into them (accumulate)."""
    F = x.shape[1]
    n_long = int(long_rows.shape[0])
    if out.numel() == 0 or n_items + n_long == 0:
        return
    vector = F % 8 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    fn = KERNEL.fn()
    err = fn(
        rowptr.data_ptr(), col.data_ptr(), eid.data_ptr(), w.data_ptr(),
        items.data_ptr(), long_rows.data_ptr(), x.data_ptr(), out.data_ptr(),
        n_items, n_long, F, int(x.dtype == torch.bfloat16), int(accumulate),
        int(vector), stream_handle(x),
    )
    KERNEL.launches += 1
    KERNEL.check(err)


# K1 as the torch.library ops mgtpu::segment_spmm_csr (a new output) and
# mgtpu::segment_spmm_csr_acc (adds into out in place, declared as a
# mutation): tensors and ints only, so torch.export can trace them.  The CPU
# kernel is the plain version; the CUDA kernel launches K1; the fake
# function takes the output's shape from rowptr and x.  Defined with
# torch.library.define / impl rather than torch.library.custom_op, whose
# Python autograd and aliasing layers run on the host at every call
# (probes/op_dispatch.py times a call's host cost).
_K1_ARGS = ("Tensor x, Tensor w, Tensor rowptr, Tensor col, Tensor eid, Tensor row, "
            "Tensor items, Tensor long_rows")
torch.library.define("mgtpu::segment_spmm_csr", f"({_K1_ARGS}) -> Tensor")
torch.library.define("mgtpu::segment_spmm_csr_acc",
                     f"(Tensor(a!) out, {_K1_ARGS}, SymInt n_busy) -> ()")


@torch.library.impl("mgtpu::segment_spmm_csr", "cpu")
def _(x, w, rowptr, col, eid, row, items, long_rows):
    return _k1_plain(x, w, col, eid, row, rowptr.shape[0] - 1)


@torch.library.impl("mgtpu::segment_spmm_csr", "cuda")
def _(x, w, rowptr, col, eid, row, items, long_rows):
    out = torch.empty((rowptr.shape[0] - 1, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    _k1_launch(out, x, w, rowptr, col, eid, items, long_rows,
               int(items.shape[0]), False)
    return out


@torch.library.register_fake("mgtpu::segment_spmm_csr")
def _(x, w, rowptr, col, eid, row, items, long_rows):
    return x.new_empty((rowptr.shape[0] - 1, x.shape[1]), dtype=torch.float32)


@torch.library.impl("mgtpu::segment_spmm_csr_acc", "cpu")
def _(out, x, w, rowptr, col, eid, row, items, long_rows, n_busy):
    out.add_(_k1_plain(x, w, col, eid, row, rowptr.shape[0] - 1))


@torch.library.impl("mgtpu::segment_spmm_csr_acc", "cuda")
def _(out, x, w, rowptr, col, eid, row, items, long_rows, n_busy):
    _k1_launch(out, x, w, rowptr, col, eid, items, long_rows, n_busy, True)


@torch.library.register_fake("mgtpu::segment_spmm_csr_acc")
def _(out, x, w, rowptr, col, eid, row, items, long_rows, n_busy):
    return None


segment_spmm_csr_op = torch.ops.mgtpu.segment_spmm_csr.default
segment_spmm_csr_acc_op = torch.ops.mgtpu.segment_spmm_csr_acc.default


def segment_spmm_csr(
    x: torch.Tensor,
    w: torch.Tensor,
    plan: CSRPlan,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """out[n] = sum_{e in row n} w[eid[e]] * x[col[e]], accumulated in f32.

    x: (rows, F) bf16 or f32; w: (E,) f32 per original edge, rounded to
    bf16 when x is bf16.  Returns (n_rows, F) f32.  With ``out`` given,
    adds into it in place (rows with no entries are left as they are).  A
    CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
    _check_inputs(x, w, plan, out)
    args = (plan.rowptr, plan.col, plan.eid, plan.row, plan.items, plan.long_rows)
    if out is None:
        return segment_spmm_csr_op(x, w, *args)
    segment_spmm_csr_acc_op(out, x, w, *args, plan.n_busy)
    return out


@dataclasses.dataclass(frozen=True)
class SortedPlan:
    """Segment ids sorted once, for K4 (``SortedSegments.build``'s id
    handling, segment_sum.py:118-123).

    Rows with mask False, a negative id or an id >= num_segments are
    dropped; the kept rows take positions 0..n_kept-1 of the stable sorted
    order, the dropped ones follow.
    rowptr: (num_segments + 1,) int32; segment n owns sorted positions
    rowptr[n]:rowptr[n+1].
    perm:   (n_ids,) int32 original row of each sorted position, or None
    when the ids are already in order (the stable argsort is the identity).
    seg:    (n_kept,) int32 segment of each kept sorted position (the plain
    version's index).
    csr:    K1's plan over the kept rows in their original order (rows =
    segments, columns and weight ids = original rows): segment_sum_by on
    2-D data."""

    rowptr: torch.Tensor
    perm: Optional[torch.Tensor]
    seg: torch.Tensor
    csr: CSRPlan
    num_segments: int
    n_ids: int
    n_kept: int

    @staticmethod
    def build(
        ids: np.ndarray, num_segments: int, mask: Optional[np.ndarray] = None
    ) -> "SortedPlan":
        ids = np.asarray(ids, np.int64).copy()
        if mask is not None:
            ids = np.where(np.asarray(mask), ids, num_segments)
        ids = np.where((ids < 0) | (ids >= num_segments), num_segments, ids)
        order = np.argsort(ids, kind="stable")
        sorted_ids = ids[order]
        n_kept = int(np.searchsorted(sorted_ids, num_segments, "left"))
        rowptr = np.searchsorted(sorted_ids, np.arange(num_segments + 1), "left")
        identity = bool(np.all(order == np.arange(len(order))))
        kept = order[:n_kept]

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32))

        return SortedPlan(
            rowptr=t(rowptr),
            perm=None if identity else t(order),
            seg=t(sorted_ids[:n_kept]),
            csr=CSRPlan.build(ids[kept], kept, kept, num_segments),
            num_segments=int(num_segments),
            n_ids=len(ids),
            n_kept=n_kept,
        )

    def to(self, device) -> "SortedPlan":
        return dataclasses.replace(
            self,
            rowptr=self.rowptr.to(device),
            perm=self.perm.to(device) if self.perm is not None else None,
            seg=self.seg.to(device),
            csr=self.csr.to(device),
        )


def _check_sorted_inputs(data, plan):
    if data.dim() not in (2, 3) or not data.is_contiguous():
        raise ValueError("data must be a contiguous (E, C) or (B, E, C) tensor")
    if data.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"data dtype {data.dtype} not supported (bf16 or f32)")
    if data.shape[-2] != plan.n_ids:
        raise ValueError(f"data has {data.shape[-2]} rows, the plan {plan.n_ids}")
    if plan.rowptr.device != data.device:
        raise ValueError("data and the plan must be on one device")


def _k4_plain(data, perm, seg, num_segments: int) -> torch.Tensor:
    n_kept = seg.shape[0]
    rows = data if perm is None else data.index_select(-2, perm[:n_kept].long())
    rows = rows.narrow(-2, 0, n_kept).float()
    out = torch.zeros(
        data.shape[:-2] + (num_segments, data.shape[-1]),
        dtype=torch.float32, device=data.device,
    )
    return out.index_add_(data.dim() - 2, seg.long(), rows)


def sorted_segment_sum_plain(
    data: torch.Tensor, plan: SortedPlan, permuted: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of sorted_segment_sum (permuted=False: rows in
    the plan's sorted order) and of K4 in segment_sum_by (permuted=True:
    rows in their original order, read through perm)."""
    return _k4_plain(data, plan.perm if permuted else None, plan.seg,
                     plan.num_segments)


# K4 as the torch.library op mgtpu::sorted_segment_sum: perm None reads the
# rows in sorted order, a perm reads them through it (segment_sum_by).
torch.library.define("mgtpu::sorted_segment_sum",
                     "(Tensor data, Tensor rowptr, Tensor? perm, Tensor seg) -> Tensor")


@torch.library.impl("mgtpu::sorted_segment_sum", "cpu")
def _(data, rowptr, perm, seg):
    return _k4_plain(data, perm, seg, rowptr.shape[0] - 1)


@torch.library.impl("mgtpu::sorted_segment_sum", "cuda")
def _(data, rowptr, perm, seg):
    B = data.shape[0] if data.dim() == 3 else 1
    E, C = data.shape[-2], data.shape[-1]
    num_segments = rowptr.shape[0] - 1
    out = torch.empty(
        data.shape[:-2] + (num_segments, C), dtype=torch.float32,
        device=data.device,
    )
    if out.numel() == 0:
        return out
    vector = C % 8 == 0 and data.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    fn = SORTED_KERNEL.fn()
    err = fn(
        rowptr.data_ptr(), perm.data_ptr() if perm is not None else None,
        data.data_ptr(), out.data_ptr(), B, num_segments, E, C,
        int(data.dtype == torch.bfloat16), int(vector), stream_handle(data),
    )
    SORTED_KERNEL.launches += 1
    SORTED_KERNEL.check(err)
    return out


@torch.library.register_fake("mgtpu::sorted_segment_sum")
def _(data, rowptr, perm, seg):
    return data.new_empty(data.shape[:-2] + (rowptr.shape[0] - 1, data.shape[-1]),
                          dtype=torch.float32)


sorted_segment_sum_op = torch.ops.mgtpu.sorted_segment_sum.default


def sorted_segment_sum(data: torch.Tensor, plan: SortedPlan) -> torch.Tensor:
    """(B, E, C) or (E, C) bf16 / f32 rows already in the plan's sorted
    order -> (B, N, C) / (N, C) f32 segment sums; empty segments 0; the
    dropped rows (past n_kept) are ignored.  A CPU tensor takes the plain
    version; a CUDA tensor launches K4."""
    _check_sorted_inputs(data, plan)
    return sorted_segment_sum_op(data, plan.rowptr, None, plan.seg)


def segment_sum_by(data: torch.Tensor, plan: SortedPlan) -> torch.Tensor:
    """Like sorted_segment_sum, with the rows in their original order.  As in
    the JAX package (segment_sum.py:585-599), 2-D data goes to K1 (unit
    weights over the plan's csr) and 3-D data to K4, which reads the rows
    through perm instead of writing a permuted copy."""
    _check_sorted_inputs(data, plan)
    if data.dim() == 2:
        ones = torch.ones(plan.n_ids, dtype=torch.float32, device=data.device)
        return segment_spmm_csr(data, ones, plan.csr)
    return sorted_segment_sum_op(data, plan.rowptr, plan.perm, plan.seg)
