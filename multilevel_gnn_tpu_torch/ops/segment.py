"""Segment reductions used by the kernels' plain PyTorch versions.

Port of the part of multilevel_gnn_tpu/ops/segment.py that the plain
versions need: a sum over the leading axis by segment id, where an empty
segment gives 0 (torch_scatter semantics).  Ids must lie in
[0, num_segments); callers drop padding edges before they get here.
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
