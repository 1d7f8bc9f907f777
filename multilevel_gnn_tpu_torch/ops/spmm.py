"""Batched sparse aggregation (SpMM) over a static edge list, with the
kernels' backwards.

Port of multilevel_gnn_tpu/ops/spmm.py: ``gather_scatter`` (:381-458) with
the custom VJPs it reaches (the composed ``_fused_spmm_sum`` :137-192,
``windowed_spmm_2d``, ops/pallas/windowed.py:710-810, and
``edge_segment_max`` :235-274), ``edge_segment_min`` (:277),
``gather_rows`` (:302-334) and the edge gathers ``gather_src`` /
``gather_dst`` (:364-378).  Each custom VJP is a
``torch.autograd.Function``:

  composed SpMM   forward K1 over csr; backward K1 over csc
  windowed SpMM   forward K2 (forward side) + K1 over the residual;
                  backward K2 (transpose side) + K1 over tres + K1 over
                  res_csc, added in place
  gather_rows     forward index_select; backward K1 over a CSR whose rows
                  are node slots and whose columns are the gathered rows,
                  unit weights (no atomics, unlike index_select's backward);
                  the edge gathers use the graph's src_gather / dst_gather
  segment max     forward K3 over csr; backward JAX's gather-only form in
                  torch ops: the full cotangent to every real edge equal to
                  its segment's max (ties each get all of it, where
                  scatter_reduce's autograd would split it)

As in the JAX package, the cotangent is cast to the forward's SpMM data
type before the kernel (its "dtype witness"), the gradient comes back in
the primal dtype, and edge weights and plans get no gradient (they are
data, spmm.py:10-17).

Layout: the port keeps the trunk node-major, (N, B, C), so the SpMM reads
it as (N, B*C) rows without the transpose the JAX package's
``_to_2d``/``_from_2d`` (:121-134) do around it; the values are the same.
Dispatch: a graph with a window plan goes through the windowed path,
otherwise K1 over all real edges.  Accumulation is f32; the result is f32.
The kernels are reached through their torch.library ops (mgtpu::*), so an
eval forward traced by torch.export under torch.no_grad() (train/export.py)
records each Function's forward, op calls included; plain_versions() calls
the plain Python functions directly, never the ops.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.ops.kernels.segment_max import (
    segment_max_csr,
    segment_max_csr_plain,
)
from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import (
    CSRPlan,
    segment_spmm_csr,
    segment_spmm_csr_plain,
)
from multilevel_gnn_tpu_torch.ops.kernels.windowed import (
    WindowPlan,
    windowed_spmm,
    windowed_spmm_plain,
)

_PLAIN = False


@contextlib.contextmanager
def plain_versions():
    """Inside this block the SpMMs, the segment max and gather_rows call
    the kernels' plain PyTorch versions on any device, forward and
    backward, to hold a whole step with kernels against the same step
    without them on the card.  A backward runs the way its forward did,
    wherever it is called."""
    global _PLAIN
    prev, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = prev


def _k1(plain: bool):
    return segment_spmm_csr_plain if plain else segment_spmm_csr


def _k2(plain: bool):
    return windowed_spmm_plain if plain else windowed_spmm


def _k3(plain: bool):
    return segment_max_csr_plain if plain else segment_max_csr


class _ComposedSpMM(torch.autograd.Function):
    """_fused_spmm_sum (spmm.py:137-192).  The cast to the SpMM dtype
    happens inside, so the gradient goes straight back to x's dtype
    (spmm.py:179-181)."""

    @staticmethod
    def forward(ctx, x2, w, csr: CSRPlan, csc: CSRPlan, dtype, plain: bool):
        xd = (x2 if dtype is None else x2.to(dtype)).contiguous()
        ctx.save_for_backward(w)
        ctx.csc, ctx.plain = csc, plain
        ctx.data_dtype, ctx.x_dtype = xd.dtype, x2.dtype
        return _k1(plain)(xd, w, csr)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        dx = _k1(ctx.plain)(g.to(ctx.data_dtype).contiguous(), w, ctx.csc)
        return dx.to(ctx.x_dtype), None, None, None, None, None


class _WindowedSpMM(torch.autograd.Function):
    """windowed_spmm_2d (windowed.py:710-810): x2 arrives already in the
    SpMM dtype, so the gradient is in that dtype too (:791-792)."""

    @staticmethod
    def forward(ctx, x2, w, plan: WindowPlan, plain: bool):
        ctx.save_for_backward(w)
        ctx.plan, ctx.plain, ctx.x_dtype = plan, plain, x2.dtype
        return _k2(plain)(x2, w, plan)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        gd = g.to(ctx.x_dtype).contiguous()
        dx = _k2(ctx.plain)(gd, w, ctx.plan, transpose=True)
        return dx.to(ctx.x_dtype), None, None, None


class _GatherRows(torch.autograd.Function):
    """gather_rows (spmm.py:302-334) on the node axis of a node-major
    tensor; the backward sums the gathered rows' cotangents into their
    node slots with K1 (unit weights) and returns them in x's dtype."""

    @staticmethod
    def forward(ctx, x, idx, seg: CSRPlan, plain: bool):
        ctx.seg, ctx.plain, ctx.x_dtype = seg, plain, x.dtype
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        seg = ctx.seg
        g2 = g.reshape(g.shape[0], -1).contiguous()
        ones = torch.ones(g.shape[0], dtype=torch.float32, device=g.device)
        dx = _k1(ctx.plain)(g2, ones, seg)
        return dx.reshape((seg.n_rows,) + g.shape[1:]).to(ctx.x_dtype), None, None, None


class _EdgeSegmentMax(torch.autograd.Function):
    """edge_segment_max (spmm.py:235-274) on (E, F) edge rows: K3 forward
    (f32 out); the backward sends the cotangent to every real edge whose
    value equals its segment's max and returns it in the rows' dtype."""

    @staticmethod
    def forward(ctx, m2, receivers, mask, csr: CSRPlan, plain: bool):
        out = _k3(plain)(m2, csr)
        ctx.save_for_backward(m2, out, receivers, mask)
        return out

    @staticmethod
    def backward(ctx, g):
        m2, out, receivers, mask = ctx.saved_tensors
        # out holds elements of m2 (or 0), so its cast to m2's dtype is
        # exact, and casting g before the select gives what JAX's select
        # then cast gives; both casts run on node rows, so the edge-row
        # passes below move m2's dtype, not f32
        o = out.to(m2.dtype).index_select(0, receivers)
        sel = (m2 == o) & mask[:, None]
        d = torch.where(sel, g.to(m2.dtype).index_select(0, receivers), 0.0)
        return d, None, None, None, None


def edge_segment_max(
    msg: torch.Tensor, receivers: torch.Tensor, mask: torch.Tensor, csr: CSRPlan
) -> torch.Tensor:
    """Segment-max of edge values into receivers, differentiable in msg.

    msg: (E, ...) edge-major values, bf16 or f32, over all E edge slots
    (padding included); returns (N, ...) float32 with N = csr.n_rows.  An
    empty segment gives 0; padding edges (mask False) take no part and get
    no gradient."""
    shape = msg.shape
    m2 = msg.reshape(shape[0], -1).contiguous()
    out = _EdgeSegmentMax.apply(m2, receivers, mask, csr, _PLAIN)
    return out.reshape((csr.n_rows,) + tuple(shape[1:]))


def edge_segment_min(msg, receivers, mask, csr) -> torch.Tensor:
    """min(x) = -max(-x), with the same empty -> 0 fill (spmm.py:277)."""
    return -edge_segment_max(-msg, receivers, mask, csr)


def edge_weights(
    graph: Graph, reduce: str, edge_weight: Optional[torch.Tensor]
) -> torch.Tensor:
    """(E,) float32 per-edge weights: edge_weight (or 1), times
    1/in_degree[receiver] for the mean (spmm.py:422-429)."""
    if edge_weight is None:
        w = torch.ones(
            graph.num_padded_edges, dtype=torch.float32,
            device=graph.receivers.device,
        )
    else:
        if edge_weight.dim() == 2:
            if edge_weight.shape[1] != 1:
                raise ValueError("edge_weight must be (E,) or (E, 1)")
            edge_weight = edge_weight[:, 0]
        w = edge_weight.float()
    if reduce == "mean":
        inv = 1.0 / torch.clamp(graph.in_degree(), min=1.0)
        w = w * inv.index_select(0, graph.receivers)
    return w.contiguous()


def gather_scatter(
    x: torch.Tensor,
    graph: Graph,
    reduce: str = "sum",
    edge_weight: Optional[torch.Tensor] = None,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """out[dst] = reduce_{e: recv[e]=dst} x[src[e]] * w[e], reduce in
    {sum, add, mean, max, min}, differentiable in x.

    x: node-major (N, ...) features; returns float32 of the same shape.
    dtype: SpMM data type of sum and mean (bf16 halves the bytes read; f32
    accumulate).  max and min gather the messages in x's dtype (times the
    weights, if any) and reduce them with K3 (spmm.py:448-458); an empty
    segment gives 0."""
    if reduce not in ("sum", "add", "mean", "max", "min"):
        raise NotImplementedError(f"reduce={reduce!r} is not ported yet")
    if graph.csr is None:
        raise ValueError("graph needs with_sorted_meta() before aggregation")
    if reduce in ("max", "min"):
        msg = gather_src(x, graph)
        if edge_weight is not None:
            w = edge_weight.reshape(
                (msg.shape[0],) + (1,) * (msg.dim() - edge_weight.dim())
                + tuple(edge_weight.shape[1:])
            )
            msg = msg * w
        fn = edge_segment_max if reduce == "max" else edge_segment_min
        return fn(msg, graph.receivers, graph.edge_mask, graph.csr)
    shape = x.shape
    x2 = x.reshape(shape[0], -1)
    w = edge_weights(graph, reduce, edge_weight)
    if graph.winplan is not None:
        # the cast sits outside the windowed op, as at spmm.py:437-443
        x2 = (x2 if dtype is None else x2.to(dtype)).contiguous()
        out = _WindowedSpMM.apply(x2, w, graph.winplan, _PLAIN)
    else:
        out = _ComposedSpMM.apply(x2, w, graph.csr, graph.csc, dtype, _PLAIN)
    return out.reshape(shape)


def spmm_sum(x, graph, edge_weight=None, dtype=None):
    return gather_scatter(x, graph, "sum", edge_weight, dtype)


def spmm_mean(x, graph, edge_weight=None, dtype=None):
    return gather_scatter(x, graph, "mean", edge_weight, dtype)


def gather_rows(x: torch.Tensor, idx: torch.Tensor, seg: CSRPlan) -> torch.Tensor:
    """Row gather x[idx] on the node axis of a node-major tensor, with K1
    as its backward.  idx must be resolved (non-negative); seg is
    CSRPlan.gather(idx, x.shape[0]) on x's device."""
    return _GatherRows.apply(x, idx, seg, _PLAIN)


def gather_src(x: torch.Tensor, graph: Graph) -> torch.Tensor:
    """x[senders] on the node axis (E, ...), K1 over src_gather as its
    backward (spmm.py:364-370)."""
    return _GatherRows.apply(x, graph.senders, graph.src_gather, _PLAIN)


def gather_dst(x: torch.Tensor, graph: Graph) -> torch.Tensor:
    """x[receivers] on the node axis (E, ...), K1 over dst_gather as its
    backward (spmm.py:373-378)."""
    return _GatherRows.apply(x, graph.receivers, graph.dst_gather, _PLAIN)
