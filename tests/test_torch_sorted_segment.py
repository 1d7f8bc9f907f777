"""K4's plain version against the JAX package's sorted_segment_sum and
segment_sum_by (Pallas in interpret mode on the CPU).

- sorted_segment_sum, 3-D (K4a) and 2-D (K4b), on sorted ids: the cases of
  tests/test_pallas_segment.py, (E, N, C, B) = (700, 300, 64, 1),
  (1000, 150, 96, 3), (50, 700, 130, 2).
- segment_sum_by, 3-D (K4 through perm) and 2-D (K1), with unsorted ids,
  negative ids and masked rows dropped; and a hub-skewed segment with many
  empty ones.
- SortedPlan against SortedSegments: perm (None when sorted) and the kept
  rows.

Each in f32 and bf16, held to 1e-5 x max(1, max|ref|): both sides sum the
same exact values in f32 (bf16 -> f32 is exact), in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.ops.pallas import segment_sum as jseg
from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import (
    SortedPlan,
    segment_sum_by,
    sorted_segment_sum,
)

TOL = 1e-5
DTYPES = ["float32", "bfloat16"]


def _data(rng, shape, dtype):
    """Values exact in dtype, the same on both sides."""
    x = rng.randn(*shape).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= TOL * max(1.0, float(np.abs(want).max()) if want.size else 0.0), err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "E,N,C,B", [(700, 300, 64, 1), (1000, 150, 96, 3), (50, 700, 130, 2)]
)
def test_sorted_segment_sum_matches_jax(E, N, C, B, dtype):
    rng = np.random.RandomState(0)
    ids = np.sort(rng.randint(0, N, size=E))
    seg = jseg.SortedSegments.build(ids, N, tn=128, te=256)
    plan = SortedPlan.build(ids, N)
    assert plan.perm is None and seg.perm is None and plan.n_kept == E
    t, j = _data(rng, (B, E, C), dtype)
    _close(sorted_segment_sum(t, plan), jseg.sorted_segment_sum(j, seg, interpret=True))
    # K4b: the same rows without the batch axis
    _close(sorted_segment_sum(t[0], plan),
           jseg.sorted_segment_sum(j[0], seg, interpret=True))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 3])
def test_segment_sum_by_perm_and_dropped(B, dtype):
    rng = np.random.RandomState(1)
    E, N, C = 900, 200, 64
    ids = rng.randint(-1, N, size=E)
    mask = rng.rand(E) > 0.2
    seg = jseg.SortedSegments.build(ids, N, mask=mask)
    plan = SortedPlan.build(ids, N, mask=mask)
    assert plan.perm is not None and seg.perm is not None
    np.testing.assert_array_equal(plan.perm.numpy(), np.asarray(seg.perm))
    assert plan.n_kept == int((mask & (ids >= 0)).sum())
    t, j = _data(rng, (B, E, C), dtype)
    _close(segment_sum_by(t, plan), jseg.segment_sum_by(j, seg, interpret=True))
    # 2-D data takes K1's flat path on both sides
    _close(segment_sum_by(t[0], plan), jseg.segment_sum_by(j[0], seg, interpret=True))


@pytest.mark.parametrize("dtype", DTYPES)
def test_hub_skew_and_empty_segments(dtype):
    rng = np.random.RandomState(2)
    E, N, C = 1200, 500, 40  # C not a multiple of 8
    ids = np.where(rng.rand(E) < 0.6, 7, rng.randint(300, 320, size=E))
    seg = jseg.SortedSegments.build(ids, N)
    plan = SortedPlan.build(ids, N)
    t, j = _data(rng, (2, E, C), dtype)
    got = segment_sum_by(t, plan)
    _close(got, jseg.segment_sum_by(j, seg, interpret=True))
    empty = np.setdiff1d(np.arange(N), ids)
    assert float(got[:, empty].abs().max()) == 0.0
    srt = t.index_select(1, plan.perm.long())
    _close(sorted_segment_sum(srt, plan),
           jseg.sorted_segment_sum(jnp.take(j, seg.perm, axis=-2), seg, interpret=True))


def test_rejects_wrong_inputs():
    plan = SortedPlan.build(np.array([0, 1, 1]), 2)
    with pytest.raises(ValueError):
        sorted_segment_sum(torch.zeros(4, 3), plan)
    with pytest.raises(TypeError):
        sorted_segment_sum(torch.zeros(3, 3, dtype=torch.float64), plan)
    with pytest.raises(ValueError):
        sorted_segment_sum(torch.zeros(1, 2, 3, 3), plan)
