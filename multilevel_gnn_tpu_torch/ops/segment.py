"""Segment reductions used by the kernels' plain PyTorch versions.

Port of multilevel_gnn_tpu/ops/segment.py's sum (:42) and extremes
(:85-105) over the leading axis by segment id, where an empty segment
gives 0 (torch_scatter semantics).  Ids must lie in [0, num_segments);
callers drop padding edges before they get here, where the JAX functions
take a mask.  A maximum or minimum is one of the inputs, exactly; a
non-finite one passes through (the JAX versions map it to 0: the XLA one
any of them, the Pallas kernel those below -1.5e38).
"""
from __future__ import annotations

import torch


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """out[s] = sum of data[i] over i with segment_ids[i] == s."""
    out = torch.zeros(
        (num_segments,) + tuple(data.shape[1:]),
        dtype=data.dtype,
        device=data.device,
    )
    return out.index_add_(0, segment_ids.long(), data)


def _segment_extreme(data, segment_ids, num_segments, reduce):
    out = torch.zeros(
        (num_segments,) + tuple(data.shape[1:]),
        dtype=data.dtype,
        device=data.device,
    )
    ids = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    # include_self=False: a segment with entries takes their extreme only,
    # an empty one keeps the 0 it starts from
    return out.scatter_reduce_(0, ids.expand_as(data), data, reduce, include_self=False)


def segment_max(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """out[s] = max of data[i] over i with segment_ids[i] == s; 0 if none."""
    return _segment_extreme(data, segment_ids, num_segments, "amax")


def segment_min(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """out[s] = min of data[i] over i with segment_ids[i] == s; 0 if none."""
    return _segment_extreme(data, segment_ids, num_segments, "amin")
