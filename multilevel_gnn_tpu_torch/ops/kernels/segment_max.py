"""K3: CSR segment-max over edge rows.

Counterpart of multilevel_gnn_tpu/ops/pallas/segment_max.py: the kernel
binding (``segment_max_csr``, for ``flat_segment_max`` :106 reached through
``segment_max_by`` :160) and the kernel's plain PyTorch version.

The TPU kernel needs the edge rows reordered into its flat tile layout; on
Hopper a row-per-block reduction reads them in place through the graph's
receiver-sorted ``CSRPlan`` (K1's plan over the real edges): ``rowptr`` per
destination row and ``eid``, the edge row of each entry.  A row with no
entries gives 0 (torch_scatter's zero fill); padding edges are not in the
plan, so they never reach the max.
"""
from __future__ import annotations

import ctypes

import torch

from multilevel_gnn_tpu_torch.ops.kernels.build import Kernel, register, stream_handle
from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import CSRPlan
from multilevel_gnn_tpu_torch.ops.segment import segment_max

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = register(
    Kernel(
        name="segment_max_csr",
        source="segment_max_csr.cu",
        symbol="segment_max_csr",
        # rowptr, eid, msg, out, n_rows, F, is_bf16, vector, stream
        argtypes=[_P] * 4 + [_I] * 4 + [_P],
        replaces="multilevel_gnn_tpu/ops/pallas/segment_max.py:106",
    )
)


def segment_max_csr_plain(msg: torch.Tensor, plan: CSRPlan) -> torch.Tensor:
    """Plain PyTorch version of segment_max_csr (same contract)."""
    rows = msg.index_select(0, plan.eid.long()).float()
    return segment_max(rows, plan.row, plan.n_rows)


def _check_inputs(msg, plan):
    if msg.dim() != 2 or not msg.is_contiguous():
        raise ValueError("msg must be a contiguous (rows, F) tensor")
    if msg.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"msg dtype {msg.dtype} not supported (bf16 or f32)")
    if plan.max_eid >= msg.shape[0]:
        raise ValueError("plan indexes past msg rows")
    for t in (plan.rowptr, plan.eid):
        if t.device != msg.device:
            raise ValueError("msg and the plan must be on one device")


def segment_max_csr(msg: torch.Tensor, plan: CSRPlan) -> torch.Tensor:
    """out[n] = max_{e in row n} msg[eid[e]], elementwise; 0 for a row
    without entries.

    msg: (rows, F) bf16 or f32 edge rows.  Returns (n_rows, F) f32 whose
    values are elements of msg, exactly.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    _check_inputs(msg, plan)
    if msg.device.type == "cpu":
        return segment_max_csr_plain(msg, plan)
    F = msg.shape[1]
    out = torch.empty((plan.n_rows, F), dtype=torch.float32, device=msg.device)
    if out.numel() == 0:
        return out
    vector = F % 8 == 0 and msg.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    fn = KERNEL.fn()
    err = fn(
        plan.rowptr.data_ptr(), plan.eid.data_ptr(), msg.data_ptr(),
        out.data_ptr(), plan.n_rows, F, int(msg.dtype == torch.bfloat16),
        int(vector), stream_handle(msg),
    )
    KERNEL.launches += 1
    KERNEL.check(err)
    return out
