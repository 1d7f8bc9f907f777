"""Differentiable collectives over a torch.distributed process group: the
torch idiom for what shard_map and GSPMD give the JAX package
(multilevel_gnn_tpu/parallel/).

The convention: every rank of a mesh runs the same program on its share of
the data (its rows of the batch, its block of edges) and holds a *share*
of every gradient; the world-wide sum of the shares is the gradient.  A
value that every rank computes alike (a replicated activation, the loss)
gets each rank's share of its cotangent, and the shares sum to the whole.
So each Function's backward is the linear adjoint of its forward over the
group:

  from_model_region  all_reduce(SUM) forward, all_reduce(SUM) backward
  all_gather_rows    all-gather of equal row blocks forward; its adjoint,
                     the sum of the cotangent shares' own block (a
                     reduce-scatter), backward
  local_block        the rank's row block of a replicated tensor forward;
                     zero rows elsewhere backward
  all_to_all         all_to_all_single forward; the transposed exchange
                     backward

and the train step seeds the loss with 1 / world and all-reduces the
parameter gradients over the world once (parallel/mesh.py).  Megatron's
conjugate pair (identity forward / all_reduce backward at the entry of a
partitioned region) keeps replicated gradients whole on every rank, but a
parameter applied per edge inside the region (GENConv's and DeeperGCN's
edge encoders, EdgeConv's message MLP, a learned softmax temperature) then
gets only its rank's edges' gradient; the share convention needs no entry
marker and makes those exact too.

A model's forward on the rows of one data rank carries a ``DataShard``:
Dropout draws the global batch's mask from it and keeps the rank's rows,
and the few batch-coupled statistics (DeeperGCN's MSA readout statistics,
DiffPool's link and entropy losses, the runtime PCA) take the whole batch
with ``data_sum``, ``batch_moments`` and ``data_gather``.

Gloo takes CPU tensors; two ranks sharing one card over gloo stage each
collective of CUDA tensors through host memory (``_staged``).  NCCL
collectives run on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _call(fn, ins, outs, group):
    """fn(*ins, *outs), which reads ins and writes outs, through host copies
    when the group is gloo and the tensors lie on a card; the outs are
    copied back, the ins left as they were."""
    if not any(t.is_cuda for t in ins + outs) or not _staged(group):
        fn(*ins, *outs)
        return
    host = [t.cpu() for t in outs]
    fn(*[t.cpu() for t in ins], *host)
    for t, h in zip(outs, host):
        t.copy_(h)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all_reduce of t over group (no autograd); returns t."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    _call(lambda a: dist.all_reduce(a, op=_OPS[op], group=group), [], [t], group)
    return t


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' equal-shaped tensors concatenated on dim 0, in rank order
    (no autograd)."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    k = dist.get_world_size(group)
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(k)]
    _call(lambda a, *o: dist.all_gather(list(o), a, group=group), [t], outs, group)
    return torch.cat(outs)


def all_to_all_(send: torch.Tensor, group) -> torch.Tensor:
    """send (k, ...): block q goes to rank q; returns (k, ...) whose block q
    came from rank q (no autograd)."""
    if group is None or dist.get_world_size(group) == 1:
        return send.clone()
    send = send.contiguous()
    recv = torch.empty_like(send)
    _call(lambda s, r: dist.all_to_all_single(r, s, group=group), [send], [recv], group)
    return recv


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _FromModelRegion(torch.autograd.Function):
    """all_reduce(SUM) of the ranks' partial sums; the adjoint of a sum
    whose result every rank holds is the sum of the cotangent shares."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def from_model_region(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of each rank's partial x, on every rank."""
    if group_size(group) == 1:
        return x
    return _FromModelRegion.apply(x, group)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return all_gather_cat(x, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        r = group_rank(ctx.group)
        return g[r * ctx.n:(r + 1) * ctx.n], None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' row blocks (dim 0, equal sizes) concatenated in rank
    order, on every rank; the backward sums the cotangent shares and keeps
    the rank's own block."""
    if group_size(group) == 1:
        return x
    return _AllGatherRows.apply(x, group)


class _LocalBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rank, n):
        ctx.shape, ctx.rank, ctx.n = x.shape, rank, n
        return x[rank * n:(rank + 1) * n]

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        out[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n] = g
        return out, None, None


def local_block(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Rows [r*n, (r+1)*n) of a replicated x for the group's rank r."""
    if group_size(group) == 1:
        return x[:n]
    return _LocalBlock.apply(x, group_rank(group), n)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, send, group):
        ctx.group = group
        return all_to_all_(send, group)

    @staticmethod
    def backward(ctx, g):
        # block q of the cotangent belongs to what rank q sent: send it back
        return all_to_all_(g, ctx.group), None


def all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """(k, ...) blocks exchanged over the group: block q to rank q."""
    return _AllToAll.apply(send, group)


# ---- a forward on one data rank's rows


@dataclasses.dataclass(frozen=True)
class DataShard:
    """A forward on the rows [rank * rows, (rank + 1) * rows) of a global
    batch of size * rows rows, over group.  parallel/mesh.py:DataParallel
    hands it to the model on the fold context (FoldContext.data), where
    the batch-coupled statistics below read it, and inside the dropout
    generator (nn/basic.py:RowShardGenerator)."""

    group: Optional[object]
    size: int
    rank: int
    rows: int


def _whole(shard: Optional[DataShard]) -> bool:
    return shard is None or shard.size == 1


def data_sum(t: torch.Tensor, shard: Optional[DataShard]) -> torch.Tensor:
    """The sum of t over shard's data group (each rank's part of a batch
    statistic), differentiable; t itself without a shard."""
    if _whole(shard):
        return t
    return from_model_region(t, shard.group)


def batch_moments(x: torch.Tensor, dims, shard: Optional[DataShard]) -> tuple:
    """(mean, biased variance) of x over dims, keepdim, one of them the
    batch axis: over the whole batch on a data rank (the sums of the data
    group's parts), else x.mean / x.var themselves."""
    if _whole(shard):
        return x.mean(dim=dims, keepdim=True), x.var(dim=dims, unbiased=False, keepdim=True)
    n = shard.size
    for d in dims:
        n *= x.shape[d]
    m = data_sum(x.sum(dim=dims, keepdim=True), shard) / n
    v = data_sum(((x - m) ** 2).sum(dim=dims, keepdim=True), shard) / n
    return m, v


def data_gather(t: torch.Tensor, axis: int, shard: Optional[DataShard]) -> torch.Tensor:
    """On a data rank, the whole batch of t's rank rows along axis
    (all_gather_rows); t itself without a shard."""
    if _whole(shard):
        return t
    return all_gather_rows(t.movedim(axis, 0).contiguous(), shard.group).movedim(0, axis)


def data_local(t: torch.Tensor, axis: int, shard: Optional[DataShard]) -> torch.Tensor:
    """On a data rank, the rank's rows along axis of a whole-batch t; t
    itself without a shard."""
    if _whole(shard):
        return t
    return t.narrow(axis, shard.rank * shard.rows, shard.rows)
