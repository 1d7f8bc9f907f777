"""PW: the learnable-PCA pathway contraction as a segmented gather-reduce.

Replaces no Pallas kernel: the JAX package contracts the PCA rows into
pathway slots with one one-hot einsum per PCA column
(multilevel_gnn_tpu/ops/pathway.py:44-58), which the TPU's matrix unit
runs; on the card that form is f32 products S times larger than the sum
(ops/pathway.py's dense route, which torch.vmap still takes).  Here the
host plan ``SlotPlan`` lists each slot's PCA rows, and two kernels of
``csrc/pathway_contract.cu`` read each row once:

  pathway_contract_fwd   out[k*S + s] = sum_{g in slot s} P[g, k] x[g]
  pathway_contract_bwd   dx[g] = sum_{k = K-1..0} round_x(P[g, k] gout[k*S + s]),
                         dP[g, k] = gout[k*S + s] . x[g]   (s = seg[g])

in f32 (x as stored, bf16 or f32), with K in 1..4 on the card.  Each is a
``torch.library`` op in namespace ``mgtpu`` whose CPU kernel is its plain
version below; a CUDA tensor launches the kernel.  The plain forward is a
CSR product over the plan's rows, which on the CPU sums each slot's rows
in ascending order by fused multiply-adds: the kernel's arithmetic for a
slot of one chunk.
"""
from __future__ import annotations

import ctypes
import dataclasses
import warnings
from typing import Tuple

import numpy as np
import torch

from multilevel_gnn_tpu_torch.ops.kernels.build import Kernel, register, stream_handle
from multilevel_gnn_tpu_torch.utils.profiling import span

_P, _I = ctypes.c_void_p, ctypes.c_int

# rows a block: CHUNK in csrc/pathway_contract.cu
CHUNK = 128
# PCA columns the kernels are built for
K_MAX = 4

FWD_KERNEL = register(
    Kernel(
        name="pathway_contract_fwd",
        source="pathway_contract.cu",
        symbol="pathway_contract_fwd",
        # x, p, slot_ptr, slot_rows, chunk_slot, chunk_beg, chunk_part,
        # split_slot, part_ptr, out, parts, n_chunks, n_split, S, F, K,
        # is_bf16, vector, stream
        argtypes=[_P] * 11 + [_I] * 7 + [_P],
        # no Pallas kernel: the one-hot einsum
        replaces="multilevel_gnn_tpu/ops/pathway.py:44-58",
    )
)

BWD_KERNEL = register(
    Kernel(
        name="pathway_contract_bwd",
        source="pathway_contract.cu",
        symbol="pathway_contract_bwd",
        # x, p, gout, slot_ptr, slot_rows, chunk_slot, chunk_beg, dx, dp,
        # n_chunks, S, F, K, is_bf16, vector, stream
        argtypes=[_P] * 9 + [_I] * 6 + [_P],
        replaces="multilevel_gnn_tpu/ops/pathway.py:44-58",
    )
)


@dataclasses.dataclass(frozen=True)
class SlotPlan:
    """The PCA rows of each pathway slot, built once a fold on the host.

    Rows whose slot id is negative or >= num_slots belong to no slot (the
    one-hot has no 1 for them: they add nothing, and get zero gradients).
    slot_ptr:   (S + 1,) int32; slot s owns slot_rows[slot_ptr[s]:slot_ptr[s+1]].
    slot_rows:  (n_kept,) int32 PCA rows, by slot, ascending within a slot
                (a stable sort of the ids: the ids need not be sorted).
    seg:        (n_kept,) int64 slot of each listed row (the plain versions').
    chunk_slot, chunk_beg: (n_chunks,) int32: each slot's rows cut into
                chunks of at most CHUNK, a kernel block each; an empty slot
                is one empty chunk (its output rows are written as zeros).
    chunk_part: (n_chunks,) int32 -1 for the chunk of a slot of one chunk,
                else its row of the forward's partial sums.
    split_slot, part_ptr: the slots of several chunks and their partial
                rows, part_ptr[j]:part_ptr[j+1], added in chunk order;
                n_parts = part_ptr[-1], kept on the host."""

    slot_ptr: torch.Tensor
    slot_rows: torch.Tensor
    seg: torch.Tensor
    chunk_slot: torch.Tensor
    chunk_beg: torch.Tensor
    chunk_part: torch.Tensor
    split_slot: torch.Tensor
    part_ptr: torch.Tensor
    num_slots: int
    num_rows: int
    n_parts: int

    # the tensors each op takes, in its schema's order
    FWD = ("slot_ptr", "slot_rows", "chunk_slot", "chunk_beg", "chunk_part", "split_slot",
           "part_ptr")
    BWD = ("slot_ptr", "slot_rows", "seg", "chunk_slot", "chunk_beg")

    @staticmethod
    def build(ids, num_slots: int) -> "SlotPlan":
        """The plan of (G,) slot ids (numpy or a tensor) on the CPU."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.asarray(ids, np.int64).reshape(-1)
        S = int(num_slots)
        kept = np.flatnonzero((ids >= 0) & (ids < S))
        rows = kept[np.argsort(ids[kept], kind="stable")]
        seg = ids[rows]
        counts = np.bincount(seg, minlength=S)
        ptr = np.zeros(S + 1, np.int64)
        np.cumsum(counts, out=ptr[1:])
        n_c = np.maximum(1, -(-counts // CHUNK))
        chunk_slot = np.repeat(np.arange(S), n_c)
        first = np.cumsum(n_c) - n_c
        within = np.arange(len(chunk_slot)) - first[chunk_slot]
        chunk_beg = ptr[chunk_slot] + within * CHUNK
        split_slot = np.flatnonzero(n_c > 1)
        part_ptr = np.zeros(len(split_slot) + 1, np.int64)
        np.cumsum(n_c[split_slot], out=part_ptr[1:])
        base = np.full(S, -1, np.int64)
        base[split_slot] = part_ptr[:-1]
        chunk_part = np.where(base[chunk_slot] >= 0, base[chunk_slot] + within, -1)

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32))

        return SlotPlan(
            slot_ptr=i32(ptr), slot_rows=i32(rows), seg=torch.as_tensor(seg),
            chunk_slot=i32(chunk_slot), chunk_beg=i32(chunk_beg),
            chunk_part=i32(chunk_part), split_slot=i32(split_slot),
            part_ptr=i32(part_ptr), num_slots=S, num_rows=len(ids),
            n_parts=int(part_ptr[-1]))

    def to(self, device) -> "SlotPlan":
        return dataclasses.replace(self, **{
            name: getattr(self, name).to(device) for name in {*self.FWD, *self.BWD}})

    @property
    def fwd_args(self) -> tuple:
        return tuple(getattr(self, name) for name in self.FWD)

    @property
    def bwd_args(self) -> tuple:
        return tuple(getattr(self, name) for name in self.BWD)


def _fwd_plain(x, p, slot_ptr, slot_rows) -> torch.Tensor:
    n, S = slot_rows.shape[0], slot_ptr.shape[0] - 1
    rows = slot_rows.long()
    xr = x.index_select(0, rows).float()
    pr = p.index_select(0, rows).float()
    col = torch.arange(n, dtype=slot_ptr.dtype, device=x.device)
    with warnings.catch_warnings():  # torch calls its CSR tensors beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.cat([
            torch.sparse_csr_tensor(slot_ptr, col, pr[:, k].contiguous(), (S, n),
                                    check_invariants=False) @ xr
            for k in range(p.shape[1])])


def _bwd_plain(x, p, gout, slot_rows, seg, num_slots: int):
    K = p.shape[1]
    rows = slot_rows.long()
    xr = x.index_select(0, rows)
    xf = xr.float()
    pr = p.index_select(0, rows).float()
    gk = gout.reshape(K, num_slots, -1)
    dxr = None
    dpr = torch.empty((rows.shape[0], K), dtype=torch.float32, device=x.device)
    for k in reversed(range(K)):
        gg = gk[k].index_select(0, seg)
        d = (pr[:, k:k + 1] * gg).to(x.dtype)
        dxr = d if dxr is None else dxr + d
        dpr[:, k] = (gg * xf).sum(-1)
    dx = torch.zeros_like(x).index_copy_(0, rows, dxr)
    dp = torch.zeros(p.shape, dtype=torch.float32, device=x.device).index_copy_(0, rows, dpr)
    return dx, dp


def pathway_fwd_plain(x2: torch.Tensor, p: torch.Tensor, plan: SlotPlan) -> torch.Tensor:
    """Plain PyTorch version of pathway_fwd (same contract)."""
    return _fwd_plain(x2, p, plan.slot_ptr, plan.slot_rows)


def pathway_bwd_plain(x2, p, gout, plan: SlotPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of pathway_bwd (same contract)."""
    return _bwd_plain(x2, p, gout, plan.slot_rows, plan.seg, plan.num_slots)


def _check_inputs(x2, p, plan, gout=None):
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError("x2 must be a contiguous (G, F) tensor")
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x2 dtype {x2.dtype} not supported (bf16 or f32)")
    if p.dim() != 2 or p.dtype != torch.float32 or not p.is_contiguous():
        raise ValueError("p must be a contiguous (G, K) float32 tensor")
    if p.shape[0] != x2.shape[0] or plan.num_rows != x2.shape[0]:
        raise ValueError(f"x2 has {x2.shape[0]} rows, p {p.shape[0]}, the plan "
                         f"{plan.num_rows}")
    if x2.is_cuda and not 1 <= p.shape[1] <= K_MAX:
        raise ValueError(f"the kernels take 1 to {K_MAX} PCA columns, not {p.shape[1]}")
    if gout is not None and (gout.dtype != torch.float32 or not gout.is_contiguous()
                             or tuple(gout.shape) != (p.shape[1] * plan.num_slots,
                                                      x2.shape[1])):
        raise ValueError("gout must be a contiguous (K * S, F) float32 tensor")
    for t in (p, plan.slot_ptr) + ((gout,) if gout is not None else ()):
        if t.device != x2.device:
            raise ValueError("x2, p, gout and the plan must be on one device")


torch.library.define(
    "mgtpu::pathway_contract_fwd",
    "(Tensor x, Tensor p, Tensor slot_ptr, Tensor slot_rows, Tensor chunk_slot, "
    "Tensor chunk_beg, Tensor chunk_part, Tensor split_slot, Tensor part_ptr, "
    "int n_parts) -> Tensor")
torch.library.define(
    "mgtpu::pathway_contract_bwd",
    "(Tensor x, Tensor p, Tensor gout, Tensor slot_ptr, Tensor slot_rows, Tensor seg, "
    "Tensor chunk_slot, Tensor chunk_beg) -> (Tensor, Tensor)")


@torch.library.impl("mgtpu::pathway_contract_fwd", "cpu")
def _(x, p, slot_ptr, slot_rows, chunk_slot, chunk_beg, chunk_part, split_slot, part_ptr,
      n_parts):
    return _fwd_plain(x, p, slot_ptr, slot_rows)


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


@torch.library.impl("mgtpu::pathway_contract_fwd", "cuda")
def _(x, p, slot_ptr, slot_rows, chunk_slot, chunk_beg, chunk_part, split_slot, part_ptr,
      n_parts):
    S, F, K = slot_ptr.shape[0] - 1, x.shape[1], p.shape[1]
    out = torch.empty((K * S, F), dtype=torch.float32, device=x.device)
    parts = torch.empty((n_parts, K, F), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    vector = F % 8 == 0 and _aligned(x, out, parts)
    fn = FWD_KERNEL.fn()
    err = fn(
        x.data_ptr(), p.data_ptr(), slot_ptr.data_ptr(), slot_rows.data_ptr(),
        chunk_slot.data_ptr(), chunk_beg.data_ptr(), chunk_part.data_ptr(),
        split_slot.data_ptr(), part_ptr.data_ptr(), out.data_ptr(), parts.data_ptr(),
        chunk_slot.shape[0], split_slot.shape[0], S, F, K,
        int(x.dtype == torch.bfloat16), int(vector), stream_handle(x),
    )
    FWD_KERNEL.launches += 1
    FWD_KERNEL.check(err)
    return out


@torch.library.register_fake("mgtpu::pathway_contract_fwd")
def _(x, p, slot_ptr, slot_rows, chunk_slot, chunk_beg, chunk_part, split_slot, part_ptr,
      n_parts):
    return x.new_empty((p.shape[1] * (slot_ptr.shape[0] - 1), x.shape[1]),
                       dtype=torch.float32)


@torch.library.impl("mgtpu::pathway_contract_bwd", "cpu")
def _(x, p, gout, slot_ptr, slot_rows, seg, chunk_slot, chunk_beg):
    return _bwd_plain(x, p, gout, slot_rows, seg, slot_ptr.shape[0] - 1)


@torch.library.impl("mgtpu::pathway_contract_bwd", "cuda")
def _(x, p, gout, slot_ptr, slot_rows, seg, chunk_slot, chunk_beg):
    S, F, K = slot_ptr.shape[0] - 1, x.shape[1], p.shape[1]
    # rows of no slot get zero gradients; the kernel writes every listed row
    full = slot_rows.shape[0] == x.shape[0]
    dx = torch.empty_like(x) if full else torch.zeros_like(x)
    dp = (torch.empty if full else torch.zeros)(p.shape, dtype=torch.float32,
                                                device=x.device)
    if x.numel() == 0:
        return dx, dp
    vector = F % 8 == 0 and _aligned(x, gout, dx)
    fn = BWD_KERNEL.fn()
    err = fn(
        x.data_ptr(), p.data_ptr(), gout.data_ptr(), slot_ptr.data_ptr(),
        slot_rows.data_ptr(), chunk_slot.data_ptr(), chunk_beg.data_ptr(),
        dx.data_ptr(), dp.data_ptr(), chunk_slot.shape[0], S, F, K,
        int(x.dtype == torch.bfloat16), int(vector), stream_handle(x),
    )
    BWD_KERNEL.launches += 1
    BWD_KERNEL.check(err)
    return dx, dp


@torch.library.register_fake("mgtpu::pathway_contract_bwd")
def _(x, p, gout, slot_ptr, slot_rows, seg, chunk_slot, chunk_beg):
    return torch.empty_like(x), p.new_empty(p.shape, dtype=torch.float32)


pathway_contract_fwd_op = torch.ops.mgtpu.pathway_contract_fwd.default
pathway_contract_bwd_op = torch.ops.mgtpu.pathway_contract_bwd.default


def pathway_fwd(x2: torch.Tensor, p: torch.Tensor, plan: SlotPlan) -> torch.Tensor:
    """out[k*S + s] = sum_{g in slot s} p[g, k] * x2[g], in f32.

    x2: (G, F) bf16 or f32; p: (G, K) f32.  Returns (K*S, F) f32.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    _check_inputs(x2, p, plan)
    with span("kernel.PW.fwd"):
        return pathway_contract_fwd_op(x2, p, *plan.fwd_args, plan.n_parts)


def pathway_bwd(x2: torch.Tensor, p: torch.Tensor, gout: torch.Tensor, plan: SlotPlan
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both gradients of pathway_fwd at the cotangent gout (K*S, F) f32:
    dx2 (G, F) in x2's dtype, each column's product rounded to it and the
    columns added in it, the last first; dp (G, K) f32."""
    _check_inputs(x2, p, plan, gout)
    with span("kernel.PW.bwd"):
        return pathway_contract_bwd_op(x2, p, gout, *plan.bwd_args)
