"""The ('data', 'model') mesh of ranks (port of multilevel_gnn_tpu/parallel/
mesh.py: make_mesh :34-42, shard_batch :83-84, shard_ctx :87-110,
replicate :113-115, maybe_make_mesh :118-126; make_parallel_train_step
:129-153 is train/step.py:train_step with a mesh).

One process per rank.  Rank d*M + m sits at [d, m], as JAX's reshape places
devices; its 'model' group holds the ranks of its row (the same d), its
'data' group those of its column (the same m).  Patients ride 'data': each
data rank runs the model on its rows of the global batch.  The fold graph's
edge array rides 'model': padded to a multiple of M, each model rank keeps
a contiguous block and builds that block's K1 plans (csr, csc and the
edge gathers' plans) for itself; ops/spmm.py routes every edge-touching
op of such a graph through parallel/edge_partition.py, which reduces the
ranks' partial results over the model group.  The whole graph's in-degree
and per-edge GCN coefficients are sliced, never recomputed from a block.

The train step on a mesh (train/step.py:train_step, the share convention
of parallel/comm.py): each rank gathers the per-sample outputs
(probabilities, the feature) of its data group (DataParallel), computes
make_loss_fn's loss of the whole batch as the single-device step does,
seeds it with 1 / world, and the parameter gradients are summed over the
world once (reduce_gradients).  Terms that reach a parameter
without passing the gathered outputs (the learnable-PCA feature losses, a
parameter used per edge) are shares like any other, so nothing is counted
twice.  Dropout draws the global batch's masks from the single-device
run's generator and keeps the rank's rows (nn/basic.py:RowShardGenerator).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from multilevel_gnn_tpu_torch.core.batch import Batch, FoldContext
from multilevel_gnn_tpu_torch.core.graph import Graph, _host
from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import CSRPlan
from multilevel_gnn_tpu_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (n_data, n_model) grid and its groups
    (None on a one-rank mesh); device_mesh is the torch DeviceMesh whose
    'data' and 'model' dimensions give the groups."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    device_mesh: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def rank(self) -> int:
        return self.data_rank * self.n_model + self.model_rank


def make_mesh(n_data: int, n_model: int = 1) -> Mesh:
    """The mesh over the process group's ranks (one rank, no group, for
    1 x 1).  The grid must hold exactly the group's ranks: more refuses, as
    JAX's make_mesh asserts, and fewer would leave ranks out of every
    collective."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data * n_model > world:
        raise ValueError(f"a {n_data}x{n_model} mesh needs {n_data * n_model} ranks; "
                         f"the group has {world}")
    if n_data * n_model < world:
        raise ValueError(f"a {n_data}x{n_model} mesh leaves {world - n_data * n_model} "
                         f"of the group's {world} ranks out")
    if world == 1:
        return Mesh(n_data, n_model, 0, 0)
    from torch.distributed.device_mesh import init_device_mesh

    # the mesh only hands out groups: its device type follows the backend
    dtype = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(dtype, (n_data, n_model), mesh_dim_names=("data", "model"))
    r = dist.get_rank()
    return Mesh(n_data, n_model, r // n_model, r % n_model,
                data_group=dm.get_group("data"), model_group=dm.get_group("model"),
                device_mesh=dm)


def maybe_make_mesh(cfg) -> Optional[Mesh]:
    """The configured mesh, or None for 1 x 1 (the single-device path)."""
    n_data = getattr(cfg, "mesh_data_axis", 1)
    n_model = getattr(cfg, "mesh_model_axis", 1)
    if n_data * n_model <= 1:
        return None
    return make_mesh(n_data, n_model)


def _world(mesh: Mesh):
    return None if mesh.size == 1 else dist.group.WORLD


def shard_batch(batch: Batch, mesh: Mesh) -> Batch:
    """The data rank's rows [d*B/D, (d+1)*B/D) of every field."""
    B = batch.x.shape[0]
    if B % mesh.n_data:
        raise ValueError(f"batch of {B} rows over {mesh.n_data} data ranks")
    n = B // mesh.n_data
    lo = mesh.data_rank * n

    def rows(t):
        return t[lo:lo + n] if t is not None else None

    return Batch(x=rows(batch.x), y=rows(batch.y), age=rows(batch.age),
                 sample_mask=rows(batch.sample_mask), raw_data=rows(batch.raw_data))


@dataclasses.dataclass(frozen=True)
class EdgeShard:
    """A rank's block [offset, offset + size) of the padded edge array of
    n_padded edges, over the model group."""

    group: Optional[object]
    rank: int
    n_ranks: int
    offset: int
    size: int
    n_padded: int


def padded_graph(graph: Graph, n_model: int) -> Graph:
    """graph's real edges re-padded to a multiple of n_model slots, on the
    host (JAX's shard_ctx :101-106); the graph itself when it already is."""
    E = graph.num_padded_edges
    target = -(-E // n_model) * n_model
    return graph if target == E else graph.pad_edges_to(target)


def edge_block(graph: Graph, n_model: int, rank: int, group=None) -> Graph:
    """Model rank ``rank``'s graph: its contiguous block of the edges padded
    to a multiple of n_model, the block's K1 plans (csr, csc, src_gather,
    dst_gather; column and edge ids local to the block), the whole graph's
    in-degree and gcn_self, and its slice of the whole graph's gcn_coef.
    graph: a graph built by with_sorted_meta; no window plan is built."""
    dev = graph.senders.device
    E = graph.num_padded_edges
    padded = padded_graph(graph, n_model)
    Ep = padded.num_padded_edges
    El = Ep // n_model
    lo, hi = rank * El, (rank + 1) * El
    send = _host(padded.senders)[lo:hi].astype(np.int64)
    recv = _host(padded.receivers)[lo:hi].astype(np.int64)
    mask = _host(padded.edge_mask)[lo:hi].astype(bool)
    N = graph.n_nodes
    eid = np.flatnonzero(mask & (send >= 0) & (send < N) & (recv >= 0) & (recv < N))

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype).to(dev)

    coef = graph.gcn_coef
    if coef is not None and Ep != E:
        coef = torch.cat([coef, coef.new_zeros(Ep - E)])
    attr = padded.edge_attr
    return dataclasses.replace(
        graph,
        senders=t(send, torch.int64),
        receivers=t(recv, torch.int64),
        edge_attr=t(_host(attr)[lo:hi], torch.float32) if attr is not None else None,
        edge_mask=t(mask, torch.bool),
        n_edges=int(len(eid)),
        csr=CSRPlan.build(recv[eid], send[eid], eid, N).to(dev),
        csc=CSRPlan.build(send[eid], recv[eid], eid, N).to(dev),
        src_gather=CSRPlan.build(send[eid], eid, eid, N).to(dev),
        dst_gather=CSRPlan.build(recv[eid], eid, eid, N).to(dev),
        gcn_coef=coef[lo:hi].contiguous() if coef is not None else None,
        winplan=None,
        shard=EdgeShard(group, rank, n_model, lo, El, Ep),
        halo=None,
    )


def shard_ctx(ctx: FoldContext, mesh: Mesh) -> FoldContext:
    """The model rank's fold context: ctx.graph as its edge block
    (edge_block), and DeeperGCN's edge ids (padding edges take id 0, as
    their zero attrs give) sliced to the block with their lookup plan.
    The node-level constants stay as they are; graph2 (edge_type merge)
    stays whole, computed alike on every rank."""
    g = ctx.graph
    shard = edge_block(g, mesh.n_model, mesh.model_rank, mesh.model_group)
    out = dataclasses.replace(ctx, graph=shard)
    if ctx.edge_ids is not None:
        ids = ctx.edge_ids
        Ep, lo, n = shard.shard.n_padded, shard.shard.offset, shard.shard.size
        if Ep != ids.shape[0]:
            ids = torch.cat([ids, ids.new_zeros(Ep - ids.shape[0])])
        blk = ids[lo:lo + n].contiguous()
        vocab = ctx.edge_id_gather.n_rows
        out = dataclasses.replace(
            out, edge_ids=blk,
            edge_id_gather=CSRPlan.gather(blk.cpu().numpy(), vocab).to(blk.device))
    return out


def replicate(tree, mesh: Mesh):
    """Broadcast from rank 0 over the world, in place: a module's
    parameters and buffers, an optimizer's state tensors, a tensor or a
    dict / list of tensors.  Returns tree."""
    group = _world(mesh)
    if group is None:
        return tree
    for t in _tensors(tree):
        comm._call(lambda a: dist.broadcast(a, src=0, group=group), [], [t], group)
    return tree


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree.data]
    if isinstance(tree, torch.nn.Module):
        return [t.data for t in tree.state_dict().values()]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if hasattr(tree, "state_dict"):
        return _tensors(tree.state_dict())
    return []


def reduce_gradients(params, mesh: Mesh) -> None:
    """Sum the parameters' gradient shares over the world, in one
    all_reduce of a flat f32 buffer (a missing gradient counts as 0)."""
    group = _world(mesh)
    params = [p for p in params if p.requires_grad]
    if group is None or not params:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1).float() for p in params])
    comm.all_reduce_(flat, group)
    off = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n


class DataParallel:
    """model's forward on the data rank's rows of a global batch, with the
    per-sample outputs (probabilities, the feature) gathered over the data
    group; a third output (DiffPool's losses) is already the whole batch's.
    The model sees the rank's comm.DataShard on the fold context (ctx.data)
    and, in training mode, a RowShardGenerator over the caller's
    generator.  Reads through to the model's attributes, so make_loss_fn
    takes it as the model (train/step.py: train_step, eval_step)."""

    def __init__(self, model, mesh: Mesh):
        self.model, self.mesh = model, mesh

    def __getattr__(self, name):
        return getattr(self.model, name)

    def __call__(self, batch: Batch, ctx: FoldContext, generator=None):
        mesh = self.mesh
        if mesh.n_data == 1:
            return self.model(batch, ctx, generator)
        from multilevel_gnn_tpu_torch.nn.basic import RowShardGenerator

        local = shard_batch(batch, mesh)
        n = local.x.shape[0]
        shard = comm.DataShard(mesh.data_group, mesh.n_data, mesh.data_rank, n)
        if generator is not None:
            generator = RowShardGenerator(generator, shard)
        out = self.model(local, dataclasses.replace(ctx, data=shard), generator)

        def gather(t):
            if isinstance(t, torch.Tensor) and t.dim() > 0 and t.shape[0] == n:
                return comm.all_gather_rows(t, mesh.data_group)
            return t

        return (gather(out[0]), gather(out[1])) + tuple(out[2:])
