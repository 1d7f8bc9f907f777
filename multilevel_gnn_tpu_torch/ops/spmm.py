"""Batched sparse aggregation (SpMM) over a static edge list, forward.

Port of the forward parts of multilevel_gnn_tpu/ops/spmm.py: the sum/mean
branches of ``gather_scatter`` (:381-447) and the ``gather_rows`` forward
(:302-313).

Layout: the port keeps the trunk node-major, (N, B, C), so the SpMM reads
it as (N, B*C) rows without the transpose the JAX package's
``_to_2d``/``_from_2d`` (:121-134) do around it; the values are the same.
Dispatch: a graph with a window plan goes through the windowed path (K2
over in-window edges, K1 over the residual), otherwise K1 over all real
edges.  Accumulation is f32; the result is f32.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import (
    segment_spmm_csr,
    segment_spmm_csr_plain,
)
from multilevel_gnn_tpu_torch.ops.kernels.windowed import (
    windowed_spmm,
    windowed_spmm_plain,
)

_PLAIN = False


@contextlib.contextmanager
def plain_versions():
    """Inside this block gather_scatter calls the kernels' plain PyTorch
    versions on any device, to hold a whole forward with kernels against
    the same forward without them on the card."""
    global _PLAIN
    prev, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = prev


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
    {sum, add, mean}.

    x: node-major (N, ...) features; returns float32 of the same shape.
    dtype: SpMM data type (bf16 halves the bytes read; f32 accumulate)."""
    if reduce not in ("sum", "add", "mean"):
        raise NotImplementedError(f"reduce={reduce!r} is not ported yet")
    if graph.csr is None:
        raise ValueError("graph needs with_sorted_meta() before aggregation")
    shape = x.shape
    x2 = x.reshape(shape[0], -1)
    if dtype is not None:
        x2 = x2.to(dtype)
    x2 = x2.contiguous()
    w = edge_weights(graph, reduce, edge_weight)
    if graph.winplan is not None:
        fn = windowed_spmm_plain if _PLAIN else windowed_spmm
        out = fn(x2, w, graph.winplan)
    else:
        fn = segment_spmm_csr_plain if _PLAIN else segment_spmm_csr
        out = fn(x2, w, graph.csr)
    return out.reshape(shape)


def spmm_sum(x, graph, edge_weight=None, dtype=None):
    return gather_scatter(x, graph, "sum", edge_weight, dtype)


def spmm_mean(x, graph, edge_weight=None, dtype=None):
    return gather_scatter(x, graph, "mean", edge_weight, dtype)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather x[idx] on the node axis of a node-major tensor
    (spmm.py:302-313 forward).  idx must be resolved (non-negative)."""
    return x.index_select(0, idx)
