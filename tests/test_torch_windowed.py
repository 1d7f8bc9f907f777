"""K2 (windowed SpMM, ops/kernels/windowed.py) of the PyTorch port against
the JAX package's windowed plan and windowed_spmm_2d (Pallas interpret).

Plan: on the same graph the port's build_plan / choose_node_perm give the
same node permutation, residual count, in-window fraction and residual
edge-id set as JAX's: required equal.  The port's plan also covers every
in-window edge exactly once.

Forward (plain versions on the CPU: K2 in-window + K1 residual) against
JAX windowed_spmm_2d on banded, random (heavy residual), permuted + masked
and empty graphs.  Tolerances:
  f32:  rtol = atol = 1e-5.
  bf16: max|port_bf16 - jax_f32| <= 1.5 * max|jax_bf16 - jax_f32| + 1e-3.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multilevel_gnn_tpu.ops.pallas import windowed as JW
from multilevel_gnn_tpu_torch.ops.kernels import windowed as W


def _rand_graph(rng, n, e, banded=None):
    src = rng.randint(0, n, e)
    if banded is not None:
        dst = np.clip(src + rng.randint(-banded, banded + 1, e), 0, n - 1)
    else:
        dst = rng.randint(0, n, e)
    w = rng.randn(e).astype(np.float32)
    return src.astype(np.int64), dst.astype(np.int64), w


def _two_communities(rng, n, e):
    comm = rng.randint(0, 2, n)
    order = np.argsort(rng.rand(n))
    src, dst = [], []
    for _ in range(e):
        c = rng.randint(0, 2)
        nodes = order[comm[order] == c]
        src.append(nodes[rng.randint(len(nodes))])
        dst.append(nodes[rng.randint(len(nodes))])
    return np.array(src), np.array(dst), rng.randn(e).astype(np.float32)


def _jax_res_set(jp):
    r = np.asarray(jp.res_idx) if jp.res_idx is not None else np.zeros(0, int)
    return np.sort(r[r < jp.n_edges])


def _cases():
    rng = np.random.RandomState(0)
    out = []
    s, d, w = _rand_graph(rng, 700, 4000, banded=40)
    out.append(("banded", s, d, w, None, 256, 2, 1))
    s, d, w = _rand_graph(rng, 500, 3000)
    out.append(("random", s, d, w, None, 128, 1, 1))
    s, d, w = _two_communities(np.random.RandomState(1), 600, 3000)
    mask = np.random.RandomState(2).rand(len(s)) > 0.1
    out.append(("perm_mask", s, d, w, mask, 128, 2, 1))
    # gene-level communities in the 3*gene+omics interleave
    r3 = np.random.RandomState(3)
    gs, gd, w = _two_communities(r3, 200, 2000)
    om = r3.randint(0, 3, len(gs))
    out.append(("perm_group3", 3 * gs + om, 3 * gd + om, w, None, 128, 2, 3))
    out.append(("empty", np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32), None, 128, 2, 1))
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


def _plans(case):
    name, s, d, w, mask, Wb, nwin, group = case
    n = max(int(s.max()) + 1 if len(s) else 1, int(d.max()) + 1 if len(d) else 1)
    n = max(n, 300)
    sm = s[mask] if mask is not None else s
    dm = d[mask] if mask is not None else d
    jperm, jf_id, jf_best = JW.choose_node_perm(sm, dm, n, Wb=Wb, nwin=nwin, group=group)
    perm, f_id, f_best = W.choose_node_perm(sm, dm, n, Wb=Wb, nwin=nwin, group=group)
    assert (perm is None) == (jperm is None)
    if perm is not None:
        np.testing.assert_array_equal(perm, jperm)
    assert (f_id, f_best) == (jf_id, jf_best)
    jp = JW.build_plan(s, d, n, mask=mask, perm=jperm, Wb=Wb, nwin=nwin)
    pp = W.build_plan(s, d, n, mask=mask, perm=perm, Wb=Wb, nwin=nwin)
    return n, jp, pp


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plan_matches_jax(case):
    name, s, d, w, mask, Wb, nwin, group = case
    n, jp, pp = _plans(case)
    assert pp.n_res == int(jp.n_res)
    assert pp.in_window_frac == float(jp.in_window_frac)
    np.testing.assert_array_equal(pp.res_eid, _jax_res_set(jp))
    if name.startswith("perm"):
        assert pp.perm is not None and pp.row_of is not None
    # every kept edge is either in a window entry or residual, once
    kept = np.arange(len(s)) if mask is None else np.flatnonzero(mask)
    both = np.concatenate([pp.fwd.edge_eid.numpy(), pp.res_eid])
    np.testing.assert_array_equal(np.sort(both), kept)
    assert pp.fwd.tile_blk_ptr.numpy()[-1] == pp.fwd.n_blocks
    assert pp.fwd.blk_ent_ptr.numpy()[-1] == pp.fwd.n_entries
    assert pp.fwd.ent_edge_ptr.numpy()[-1] == pp.fwd.n_in


def _jax_fwd(x, w, s, d, jp, mask, bf16):
    wm = w if mask is None else w * mask
    xj = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    out = JW.windowed_spmm_2d(
        xj, jnp.asarray(wm[:, None]), jnp.asarray(s, jnp.int32),
        jnp.asarray(d, jnp.int32), jp,
    )
    return np.asarray(out, np.float64)


def _port_fwd(x, w, pp, bf16):
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
    out = W.windowed_spmm(xt, torch.from_numpy(w), pp)
    assert out.dtype == torch.float32
    return out.numpy().astype(np.float64)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_windowed_forward_f32_matches_jax(case):
    name, s, d, w, mask, Wb, nwin, group = case
    n, jp, pp = _plans(case)
    x = np.random.RandomState(5).randn(n, 48).astype(np.float32)
    ref = _jax_fwd(x, w, s, d, jp, mask, bf16=False)
    out = _port_fwd(x, w, pp, bf16=False)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES[1:3], ids=IDS[1:3])
def test_windowed_forward_bf16_within_bound(case):
    name, s, d, w, mask, Wb, nwin, group = case
    n, jp, pp = _plans(case)
    x = np.random.RandomState(6).randn(n, 32).astype(np.float32)
    j32 = _jax_fwd(x, w, s, d, jp, mask, bf16=False)
    j16 = _jax_fwd(x, w, s, d, jp, mask, bf16=True)
    p16 = _port_fwd(x, w, pp, bf16=True)
    assert np.abs(p16 - j32).max() <= 1.5 * np.abs(j16 - j32).max() + 1e-3


def test_build_plan_rejects_unaligned_window():
    with pytest.raises(ValueError):
        W.build_plan(np.array([0]), np.array([1]), 10, Wb=100)
