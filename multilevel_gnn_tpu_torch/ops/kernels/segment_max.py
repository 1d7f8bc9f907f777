"""K3: CSR segment-max over edge rows.

Counterpart of multilevel_gnn_tpu/ops/pallas/segment_max.py: the kernel
binding (``segment_max_csr``, for ``flat_segment_max`` :106 reached through
``segment_max_by`` :160) and the kernel's plain PyTorch version.

The TPU kernel needs the edge rows reordered into its flat tile layout; on
Hopper a row-per-block reduction reads them in place through the graph's
receiver-sorted ``CSRPlan`` (K1's plan over the real edges): ``rowptr`` per
destination row and ``eid``, the edge row of each entry.  A row with no
entries gives 0 (torch_scatter's zero fill); padding edges are not in the
plan, so they never reach the max.  The kernel is the ``torch.library`` op
``mgtpu::segment_max_csr``.
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


def _k3_plain(msg, eid, row, n_rows: int) -> torch.Tensor:
    return segment_max(msg.index_select(0, eid.long()).float(), row, n_rows)


def segment_max_csr_plain(msg: torch.Tensor, plan: CSRPlan) -> torch.Tensor:
    """Plain PyTorch version of segment_max_csr (same contract)."""
    return _k3_plain(msg, plan.eid, plan.row, plan.n_rows)


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


# K3 as the torch.library op mgtpu::segment_max_csr: the CPU kernel is the
# plain version, the CUDA kernel launches K3.
torch.library.define("mgtpu::segment_max_csr",
                     "(Tensor msg, Tensor rowptr, Tensor eid, Tensor row) -> Tensor")


@torch.library.impl("mgtpu::segment_max_csr", "cpu")
def _(msg, rowptr, eid, row):
    return _k3_plain(msg, eid, row, rowptr.shape[0] - 1)


@torch.library.impl("mgtpu::segment_max_csr", "cuda")
def _(msg, rowptr, eid, row):
    n_rows, F = rowptr.shape[0] - 1, msg.shape[1]
    out = torch.empty((n_rows, F), dtype=torch.float32, device=msg.device)
    if out.numel() == 0:
        return out
    vector = F % 8 == 0 and msg.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    fn = KERNEL.fn()
    err = fn(
        rowptr.data_ptr(), eid.data_ptr(), msg.data_ptr(), out.data_ptr(),
        n_rows, F, int(msg.dtype == torch.bfloat16), int(vector),
        stream_handle(msg),
    )
    KERNEL.launches += 1
    KERNEL.check(err)
    return out


@torch.library.register_fake("mgtpu::segment_max_csr")
def _(msg, rowptr, eid, row):
    return msg.new_empty((rowptr.shape[0] - 1, msg.shape[1]), dtype=torch.float32)


segment_max_csr_op = torch.ops.mgtpu.segment_max_csr.default


def segment_max_csr(msg: torch.Tensor, plan: CSRPlan) -> torch.Tensor:
    """out[n] = max_{e in row n} msg[eid[e]], elementwise; 0 for a row
    without entries.

    msg: (rows, F) bf16 or f32 edge rows.  Returns (n_rows, F) f32 whose
    values are elements of msg, exactly.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    _check_inputs(msg, plan)
    return segment_max_csr_op(msg, plan.rowptr, plan.eid, plan.row)
