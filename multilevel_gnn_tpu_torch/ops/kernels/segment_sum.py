"""K1: weighted CSR segment-sum with the row gather fused in; K4: the
sorted segment-sum.

Counterpart of multilevel_gnn_tpu/ops/pallas/segment_sum.py: the host plans
(``CSRPlan`` and ``SortedPlan``, for ``SortedSegments.build`` :98-192), the
kernel bindings (``segment_spmm_csr``, for ``flat_segment_sum`` :497 plus
the row gather that feeds it; ``sorted_segment_sum`` and ``segment_sum_by``,
for the functions of those names :286, :384 and :585) and the kernels'
plain PyTorch versions.

The TPU layout pads each 128-row output tile's edges to whole te-chunks so
one-hot matmuls stream them; on Hopper a row-per-block reduction reads
the gathered rows directly, so the plan is a plain receiver-sorted CSR:
``rowptr`` per output row, the source row ``col`` and original edge id
``eid`` per entry.  Weights stay per original edge and are read through
``eid`` inside the kernel.
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
        # rowptr, col, eid, w, x, out, n_rows, F, is_bf16, accumulate,
        # vector, stream
        argtypes=[_P] * 6 + [_I] * 5 + [_P],
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


@dataclasses.dataclass(frozen=True)
class CSRPlan:
    """Receiver-sorted CSR over a static edge set.

    rowptr: (n_rows + 1,) int32; entries of row n are rowptr[n]:rowptr[n+1].
    col:    (nnz,) int32 source row per entry.
    eid:    (nnz,) int32 original edge id per entry (indexes the weights).
    row:    (nnz,) int32 output row per entry (used by the plain version).
    max_col / max_eid: largest col / eid (-1 when empty), checked against
    the inputs' sizes by the wrapper."""

    rowptr: torch.Tensor
    col: torch.Tensor
    eid: torch.Tensor
    row: torch.Tensor
    n_rows: int
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

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32))

        return CSRPlan(
            rowptr=t(rowptr),
            col=t(cols),
            eid=t(eids),
            row=t(rows),
            n_rows=int(n_rows),
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
        )


def segment_spmm_csr_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    plan: CSRPlan,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of segment_spmm_csr (same contract)."""
    msg = x.index_select(0, plan.col.long()).float()
    msg = msg * w.index_select(0, plan.eid.long()).float()[:, None]
    res = segment_sum(msg, plan.row, plan.n_rows)
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
    for t in (w, plan.rowptr, plan.col, plan.eid):
        if t.device != x.device:
            raise ValueError("x, w and the plan must be on one device")
    if out is not None and (
        out.dtype != torch.float32
        or tuple(out.shape) != (plan.n_rows, x.shape[1])
        or not out.is_contiguous()
        or out.device != x.device
    ):
        raise ValueError("out must be a contiguous (n_rows, F) float32 tensor")


def segment_spmm_csr(
    x: torch.Tensor,
    w: torch.Tensor,
    plan: CSRPlan,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """out[n] = sum_{e in row n} w[eid[e]] * x[col[e]], accumulated in f32.

    x: (rows, F) bf16 or f32; w: (E,) f32 per original edge.  Returns
    (n_rows, F) f32.  With ``out`` given, adds into it in place (rows with
    no entries are left as they are).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    _check_inputs(x, w, plan, out)
    if x.device.type == "cpu":
        return segment_spmm_csr_plain(x, w, plan, out)
    F = x.shape[1]
    accumulate = out is not None
    if out is None:
        out = torch.empty((plan.n_rows, F), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    vector = F % 8 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    fn = KERNEL.fn()
    err = fn(
        plan.rowptr.data_ptr(), plan.col.data_ptr(), plan.eid.data_ptr(),
        w.data_ptr(), x.data_ptr(), out.data_ptr(),
        plan.n_rows, F, int(x.dtype == torch.bfloat16), int(accumulate),
        int(vector), stream_handle(x),
    )
    KERNEL.launches += 1
    KERNEL.check(err)
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


def sorted_segment_sum_plain(
    data: torch.Tensor, plan: SortedPlan, permuted: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of sorted_segment_sum (permuted=False: rows in
    the plan's sorted order) and of K4 in segment_sum_by (permuted=True:
    rows in their original order, read through perm)."""
    rows = data
    if permuted and plan.perm is not None:
        rows = data.index_select(-2, plan.perm[: plan.n_kept].long())
    rows = rows.narrow(-2, 0, plan.n_kept).float()
    out = torch.zeros(
        data.shape[:-2] + (plan.num_segments, data.shape[-1]),
        dtype=torch.float32, device=data.device,
    )
    return out.index_add_(data.dim() - 2, plan.seg.long(), rows)


def _sorted_kernel(data: torch.Tensor, plan: SortedPlan, perm) -> torch.Tensor:
    B = data.shape[0] if data.dim() == 3 else 1
    E, C = data.shape[-2], data.shape[-1]
    out = torch.empty(
        data.shape[:-2] + (plan.num_segments, C), dtype=torch.float32,
        device=data.device,
    )
    if out.numel() == 0:
        return out
    vector = C % 8 == 0 and data.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    fn = SORTED_KERNEL.fn()
    err = fn(
        plan.rowptr.data_ptr(), perm.data_ptr() if perm is not None else None,
        data.data_ptr(), out.data_ptr(), B, plan.num_segments, E, C,
        int(data.dtype == torch.bfloat16), int(vector), stream_handle(data),
    )
    SORTED_KERNEL.launches += 1
    SORTED_KERNEL.check(err)
    return out


def sorted_segment_sum(data: torch.Tensor, plan: SortedPlan) -> torch.Tensor:
    """(B, E, C) or (E, C) bf16 / f32 rows already in the plan's sorted
    order -> (B, N, C) / (N, C) f32 segment sums; empty segments 0; the
    dropped rows (past n_kept) are ignored.  A CPU tensor takes the plain
    version; a CUDA tensor launches K4."""
    _check_sorted_inputs(data, plan)
    if data.device.type == "cpu":
        return sorted_segment_sum_plain(data, plan)
    return _sorted_kernel(data, plan, None)


def segment_sum_by(data: torch.Tensor, plan: SortedPlan) -> torch.Tensor:
    """Like sorted_segment_sum, with the rows in their original order.  As in
    the JAX package (segment_sum.py:585-599), 2-D data goes to K1 (unit
    weights over the plan's csr) and 3-D data to K4, which reads the rows
    through perm instead of writing a permuted copy."""
    _check_sorted_inputs(data, plan)
    if data.dim() == 2:
        ones = torch.ones(plan.n_ids, dtype=torch.float32, device=data.device)
        return segment_spmm_csr(data, ones, plan.csr)
    if data.device.type == "cpu":
        return sorted_segment_sum_plain(data, plan, permuted=True)
    return _sorted_kernel(data, plan, plan.perm)
