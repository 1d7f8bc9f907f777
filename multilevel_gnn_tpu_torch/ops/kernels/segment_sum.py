"""K1: weighted CSR segment-sum with the row gather fused in.

Counterpart of multilevel_gnn_tpu/ops/pallas/segment_sum.py: the host plan
(``CSRPlan``, for ``SortedSegments.build`` :98-192), the kernel binding
(``segment_spmm_csr``, for ``flat_segment_sum`` :497 plus the row gather
that feeds it) and the kernel's plain PyTorch version.

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
