"""P1: the per-row gather probe.

Counterpart of tools/bench_dma_gather.py (the ``pallas_call`` inside
``build`` :86): the kernel binding (``dma_row_gather``) and its plain
PyTorch version.  The TPU probe gathers whole (16, 128) rows of a
(N, 16, 128) table, one async copy a row, with almost no compute, to set
the issue-rate floor of a gather fused into an SpMM; it sums the first 128
lanes of the rows it gathers, chunk by chunk of ``te`` edges, into an
(8, 128) f32 output whose 8 rows are equal.

On Hopper each gathered row is one TMA bulk copy into a ring in shared
memory (``csrc/dma_row_gather.cu``), a persistent block on each SM: one
producer warp keeps the ring's slots full across chunk boundaries, four
consumer warps sum each chunk and release the slots through mbarriers.
The chunks' sums are added in chunk order, so the result equals
``dma_row_gather_ordered`` bit for bit and two calls are equal.  The
kernel is the ``torch.library`` op ``mgtpu::dma_row_gather``.  Its entry
point on the card is ``probes/bench_dma_gather.py``.
"""
from __future__ import annotations

import ctypes

import torch

from multilevel_gnn_tpu_torch.ops.kernels.build import Kernel, register, stream_handle

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = register(
    Kernel(
        name="dma_row_gather",
        source="dma_row_gather.cu",
        symbol="dma_row_gather",
        # x3, src, partial, out, E, te, is_bf16, stream
        argtypes=[_P] * 4 + [_I] * 3 + [_P],
        replaces="tools/bench_dma_gather.py:86",
    )
)

ROW_SHAPE = (16, 128)  # one logical 2,048-wide row
OUT_ROWS = 8           # the TPU output block's rows, all equal
TE = 256               # edges a chunk (the tool's te)
TE_MAX = 1024          # the kernel's largest chunk


def dma_row_gather_plain(x3: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of dma_row_gather (same contract)."""
    s = x3[src.long(), 0, :].float().sum(0)
    return s.expand(OUT_ROWS, ROW_SHAPE[1]).contiguous()


def dma_row_gather_ordered(x3: torch.Tensor, src: torch.Tensor, te: int) -> torch.Tensor:
    """The plain version in the kernel's order of additions, equal to the
    kernel bit for bit: each chunk of te rows summed in edge order from
    0.0, one f32 vector add a row over all chunks at once, then the
    chunks' sums added in chunk order from 0.0.  The last chunk is padded
    with +0.0 rows: a sum started from +0.0 is never -0.0, so adding +0.0
    leaves it as it is."""
    E, lanes = src.shape[0], ROW_SHAPE[1]
    n_chunks = -(-E // te)
    rows = x3.new_zeros((n_chunks * te, lanes), dtype=torch.float32)
    rows[:E] = x3[src.long(), 0, :].float()
    rows = rows.view(n_chunks, te, lanes)
    part = rows.new_zeros((n_chunks, lanes))
    for j in range(te):
        part = part + rows[:, j]
    total = rows.new_zeros(lanes)
    for c in range(n_chunks):
        total = total + part[c]
    return total.expand(OUT_ROWS, lanes).contiguous()


def check_src(src: torch.Tensor, n_rows: int) -> None:
    """src's rows in [0, n_rows), checked once where the inputs are made:
    the kernel does not check them (a host sync inside the call would)."""
    if src.numel() and not (int(src.min()) >= 0 and int(src.max()) < n_rows):
        raise ValueError(f"src has rows outside [0, {n_rows})")


def _check_inputs(x3, src, te):
    if x3.dim() != 3 or tuple(x3.shape[1:]) != ROW_SHAPE or not x3.is_contiguous():
        raise ValueError(f"x3 must be a contiguous (N, {ROW_SHAPE[0]}, {ROW_SHAPE[1]}) tensor")
    if x3.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x3 dtype {x3.dtype} not supported (bf16 or f32)")
    if src.dim() != 1 or src.dtype != torch.int32:
        raise TypeError("src must be a 1-D int32 tensor")
    if not src.is_contiguous():
        raise ValueError("src must be contiguous (the kernel reads it as one array)")
    if src.device != x3.device:
        raise ValueError("x3 and src must be on one device")
    if not 1 <= te <= TE_MAX:
        raise ValueError(f"te must be in [1, {TE_MAX}]")
    if src.shape[0] >= 2 ** 31:
        raise ValueError("src must have fewer than 2^31 entries")
    if x3.is_cuda and x3.data_ptr() % 16:
        raise ValueError("x3 must be 16-byte aligned (each row is one bulk copy)")


# P1 as the torch.library op mgtpu::dma_row_gather: the CPU kernel is the
# plain version, the CUDA kernel launches P1.
torch.library.define("mgtpu::dma_row_gather", "(Tensor x3, Tensor src, int te) -> Tensor")


@torch.library.impl("mgtpu::dma_row_gather", "cpu")
def _(x3, src, te):
    return dma_row_gather_plain(x3, src)


@torch.library.impl("mgtpu::dma_row_gather", "cuda")
def _(x3, src, te):
    E = src.shape[0]
    n_chunks = -(-E // te)
    partial = torch.empty((n_chunks, ROW_SHAPE[1]), dtype=torch.float32, device=x3.device)
    out = torch.empty((OUT_ROWS, ROW_SHAPE[1]), dtype=torch.float32, device=x3.device)
    fn = KERNEL.fn()
    err = fn(
        x3.data_ptr(), src.data_ptr(), partial.data_ptr(), out.data_ptr(),
        E, te, int(x3.dtype == torch.bfloat16), stream_handle(x3),
    )
    KERNEL.launches += 1
    KERNEL.check(err)
    return out


@torch.library.register_fake("mgtpu::dma_row_gather")
def _(x3, src, te):
    return x3.new_empty((OUT_ROWS, ROW_SHAPE[1]), dtype=torch.float32)


dma_row_gather_op = torch.ops.mgtpu.dma_row_gather.default


def dma_row_gather(x3: torch.Tensor, src: torch.Tensor, te: int = TE) -> torch.Tensor:
    """out[r, l] = sum_e x3[src[e], 0, l] in f32 for r < 8, l < 128.

    x3: (N, 16, 128) bf16 or f32; src: (E,) int32 rows of x3, each in
    [0, N) (``check_src``).  The sum is taken chunk by chunk of te edges,
    each chunk in edge order, the chunks added in order.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel, which
    copies each gathered row whole."""
    _check_inputs(x3, src, te)
    return dma_row_gather_op(x3, src, te)
