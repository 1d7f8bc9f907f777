"""Edge-partitioned aggregation (port of multilevel_gnn_tpu/parallel/
edge_partition.py: edge_partitioned_gather_scatter :27-92, scaling_bench
:95-116), and the edge-shard forms of every edge-touching op of
ops/spmm.py, which routes a graph with a ``shard`` (parallel/mesh.py:
edge_block) here.

x is replicated over the model group; each rank gathers from it over its
own block of edges, reduces with the kernels over the block's plans (K1
over csr forward and csc backward; K3 for max and min) and the ranks'
partial rows are combined over the model group:

  sum / add   all_reduce(SUM) of the partial sums
  mean        the same, each edge weighted by 1 / the whole graph's
              in-degree of its receiver (psum(sum) / psum(count))
  max / min   K3 over the block, -inf on a row with no edge of the block
              (K3 writes 0 there, which would hide a negative maximum),
              all_reduce(MAX), then 0 where no rank found an edge; the
              backward sends the summed cotangent to every edge of the
              block equal to the *global* maximum (ties inclusive, as the
              single-device backward)
  softmax     the column maximum over all ranks' edges (MAX), then the
              segment sums (SUM)
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.ops import spmm
from multilevel_gnn_tpu_torch.parallel import comm


def _group(graph: Graph):
    return graph.shard.group


class _ShardSegmentMax(torch.autograd.Function):
    """edge_segment_max over the block's edges, maximum taken over the
    model group."""

    @staticmethod
    def forward(ctx, m2, receivers, mask, csr, group, plain):
        part = spmm._k3(plain)(m2, csr)
        has = (csr.rowptr[1:] - csr.rowptr[:-1]) > 0
        part = torch.where(has[:, None], part, -torch.inf)
        out = comm.all_reduce_(part, group, "max")
        out = torch.where(torch.isfinite(out), out, 0.0)
        ctx.save_for_backward(m2, out, receivers, mask)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, g):
        m2, out, receivers, mask = ctx.saved_tensors
        g = comm.all_reduce_(g.contiguous().clone(), ctx.group)
        o = out.to(m2.dtype).index_select(0, receivers)
        sel = (m2 == o) & mask[:, None]
        d = torch.where(sel, g.to(m2.dtype).index_select(0, receivers), 0.0)
        return d, None, None, None, None, None


def segment_max(msg: torch.Tensor, graph: Graph) -> torch.Tensor:
    """spmm.edge_segment_max of the block's (E_l, ...) edge values over
    the whole graph: (N, ...) float32, 0 on a row no rank has an edge of."""
    shape = msg.shape
    m2 = msg.reshape(shape[0], -1).contiguous()
    out = _ShardSegmentMax.apply(m2, graph.receivers, graph.edge_mask, graph.csr,
                                 _group(graph), spmm._PLAIN)
    return out.reshape(out.shape[:1] + tuple(shape[1:]))


def segment_sum(msg: torch.Tensor, graph: Graph) -> torch.Tensor:
    """spmm.edge_segment_sum of the block's edge values, summed over the
    model group."""
    shape = msg.shape
    m2 = msg.reshape(shape[0], -1).contiguous()
    part = spmm._EdgeSegmentSum.apply(m2, graph.receivers, graph.edge_mask,
                                      graph.dst_gather, spmm._PLAIN)
    out = comm.from_model_region(part, _group(graph))
    return out.reshape((graph.n_nodes,) + tuple(shape[1:]))


def column_max(zm: torch.Tensor, graph: Graph) -> torch.Tensor:
    """segment_softmax_weights' shift: the largest finite value of each
    column over every rank's real edges (no gradient)."""
    with torch.no_grad():
        m = torch.where(torch.isfinite(zm), zm, -1e30).amax(dim=0, keepdim=True)
        return comm.all_reduce_(m.contiguous(), _group(graph), "max")


def edge_partitioned_gather_scatter(
    x: torch.Tensor,
    graph: Graph,
    mesh=None,
    reduce: str = "sum",
    edge_weight: Optional[torch.Tensor] = None,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """out[dst] = reduce_e x[src[e]] * w[e] over the edges of every model
    rank, x replicated (N, ...) node-major; returns the replicated (N, ...)
    float32 result.  graph: the rank's edge block (shard_ctx); when it
    carries the rank's halo plans (graph.halo), sum and mean go through the
    boundary-only exchange of parallel/halo.py.  mesh is accepted for the
    JAX signature; the groups ride the graph."""
    if reduce not in ("sum", "add", "mean", "max", "min"):
        raise NotImplementedError(reduce)
    if graph.halo is not None and reduce in ("sum", "add", "mean"):
        from multilevel_gnn_tpu_torch.parallel.halo import gather_scatter_halo

        return gather_scatter_halo(x, graph, reduce, edge_weight, dtype)
    if reduce in ("max", "min"):
        msg = spmm.gather_src(x, graph)
        if edge_weight is not None:
            w = edge_weight.reshape(
                (msg.shape[0],) + (1,) * (msg.dim() - edge_weight.dim())
                + tuple(edge_weight.shape[1:]))
            msg = msg * w
        if reduce == "max":
            return segment_max(msg, graph)
        return -segment_max(-msg, graph)
    shape = x.shape
    w = spmm.edge_weights(graph, reduce, edge_weight)
    part = spmm._ComposedSpMM.apply(x.reshape(shape[0], -1), w, graph.csr, graph.csc,
                                    dtype, spmm._PLAIN)
    return comm.from_model_region(part, _group(graph)).reshape(shape)


def scaling_bench(mesh_sizes, make_fn, *args, iters: int = 5):
    """Edges/s scaling-efficiency harness: make_fn(n) -> callable, timed
    over iters calls after one warm call at each 'model' size n; returns
    ({n: s per call}, {n: efficiency against the first size}).  A
    callable on a card is synchronised before each clock read."""
    def sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    results = {}
    for n in mesh_sizes:
        fn = make_fn(n)
        fn(*args)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        sync()
        results[n] = (time.perf_counter() - t0) / iters
    base = results[mesh_sizes[0]] * mesh_sizes[0]
    eff = {n: base / (results[n] * n) for n in mesh_sizes}
    return results, eff
