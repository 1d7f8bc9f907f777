"""Backward of the PyTorch port's SpMMs and gather_rows against jax.vjp of
the JAX package's custom VJPs (pallas backend, interpret mode).

- Plan: the transpose side's in-window edge set, n_tres and the tres edge
  set equal JAX's plan.bwd and tres_idx (required equal), on the windowed
  forward test's graphs plus a residual-heavy hub graph.
- Windowed backward (windowed_spmm(..., transpose=True): K2 transpose side
  + K1 over tres + K1 over res_csc) against jax.vjp of windowed_spmm_2d on
  banded, random, permuted+masked, group-3, residual-heavy and empty
  graphs.
- Through autograd: spmm_mean on a composed graph (K1 over csc, the vjp of
  _fused_spmm_sum) and on a windowed graph, and gather_rows (repeated ids,
  ids that were -1 before resolution) against jax.vjp of gather_rows.

Tolerances:
  f32:  max|port - jax| <= 1e-5 * max(1, max|jax|).
  bf16: max|port_bf16 - jax_f32| <= 1.5 * max|jax_bf16 - jax_f32| + 1e-3
        (a bound on bf16's own error; the port rounds the edge weights as
        the JAX package does, and the transpose's tight bf16 parity with
        JAX is in test_torch_windowed.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.graph import Graph as JGraph
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu.ops.pallas import windowed as JW
from multilevel_gnn_tpu.ops.pallas.segment_sum import SortedSegments
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.ops import spmm
from multilevel_gnn_tpu_torch.ops.kernels import windowed as W
from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import CSRPlan

from test_torch_windowed import CASES as FWD_CASES
from test_torch_windowed import _plans
from torch_threads import few_threads  # noqa: F401  (autouse)


def _hub_case():
    """Banded edges plus hub rows and columns: many residual edges and many
    in-window edges whose transpose falls out of window."""
    rng = np.random.RandomState(11)
    n, e = 900, 5000
    s = rng.randint(0, n, e)
    d = np.clip(s + rng.randint(-100, 101, e), 0, n - 1)
    k = e // 8
    s[:k] = rng.randint(0, 4, k)
    d[k : 2 * k] = rng.randint(0, 4, k)
    return ("residual_heavy", s.astype(np.int64), d.astype(np.int64),
            rng.randn(e).astype(np.float32), None, 128, 2, 1)


CASES = FWD_CASES + [_hub_case()]
IDS = [c[0] for c in CASES]


def _f32_close(out, ref):
    err = np.abs(out - ref).max() if out.size else 0.0
    assert err <= 1e-5 * max(1.0, np.abs(ref).max() if ref.size else 0.0), err


def _bf16_within(p16, j16, j32):
    assert np.abs(p16 - j32).max() <= 1.5 * np.abs(j16 - j32).max() + 1e-3


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_transpose_plan_matches_jax(case):
    n, jp, pp = _plans(case)
    E = jp.n_edges
    jb = np.asarray(jp.bwd.perm_pad)
    j_in = np.sort(jb[jb < E])
    assert pp.bwd.n_in == len(j_in)
    np.testing.assert_array_equal(np.sort(pp.bwd.edge_eid.numpy()), j_in)
    assert pp.n_tres == int(jp.n_tres)
    jt = np.asarray(jp.tres_idx) if jp.tres_idx is not None else np.zeros(0, int)
    np.testing.assert_array_equal(pp.tres_eid, np.sort(jt[jt < E]))
    # every forward in-window edge is on the transpose side or in tres, once
    both = np.concatenate([pp.bwd.edge_eid.numpy(), pp.tres_eid])
    np.testing.assert_array_equal(np.sort(both), np.sort(pp.fwd.edge_eid.numpy()))
    assert pp.res_csc.nnz == pp.res.nnz == pp.n_res
    assert pp.tres.nnz == pp.n_tres
    if case[0] == "residual_heavy":
        assert pp.n_tres > 0 and pp.n_res > 0


def _jax_bwd(x, g, w, s, d, jp, mask, bf16):
    wm = w if mask is None else w * mask
    dt = jnp.bfloat16 if bf16 else jnp.float32

    def f(x2):
        return JW.windowed_spmm_2d(
            x2, jnp.asarray(wm[:, None]), jnp.asarray(s, jnp.int32),
            jnp.asarray(d, jnp.int32), jp,
        )

    _, vjp = jax.vjp(f, jnp.asarray(x, dt))
    (dx,) = vjp(jnp.asarray(g))
    return np.asarray(dx, np.float64)


def _port_bwd(g, w, pp, bf16):
    gt = torch.from_numpy(g)
    if bf16:
        gt = gt.to(torch.bfloat16)
    dx = W.windowed_spmm(gt, torch.from_numpy(w), pp, transpose=True)
    assert dx.dtype == torch.float32
    if bf16:
        dx = dx.to(torch.bfloat16)  # the gradient in the primal dtype
    return dx.float().numpy().astype(np.float64)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_windowed_backward_f32_matches_jax(case):
    name, s, d, w, mask, Wb, nwin, group = case
    n, jp, pp = _plans(case)
    rng = np.random.RandomState(21)
    x = rng.randn(n, 40).astype(np.float32)
    g = rng.randn(n, 40).astype(np.float32)
    ref = _jax_bwd(x, g, w, s, d, jp, mask, bf16=False)
    _f32_close(_port_bwd(g, w, pp, bf16=False), ref)


@pytest.mark.parametrize("case", [CASES[1], CASES[2], CASES[-1]],
                         ids=[IDS[1], IDS[2], IDS[-1]])
def test_windowed_backward_bf16_within_bound(case):
    name, s, d, w, mask, Wb, nwin, group = case
    n, jp, pp = _plans(case)
    rng = np.random.RandomState(22)
    x = rng.randn(n, 32).astype(np.float32)
    g = rng.randn(n, 32).astype(np.float32)
    j32 = _jax_bwd(x, g, w, s, d, jp, mask, bf16=False)
    j16 = _jax_bwd(x, g, w, s, d, jp, mask, bf16=True)
    _bf16_within(_port_bwd(g, w, pp, bf16=True), j16, j32)


def _graphs(windowed):
    """A banded graph with self loops and padding edges; with windowed=True
    the window plan is attached (small windows, so residual edges exist)."""
    rng = np.random.RandomState(31)
    n, e = 600, 3000
    src = rng.randint(0, n, e)
    dst = np.clip(src + rng.randint(-60, 61, e), 0, n - 1)
    hub = rng.randint(0, e, e // 10)
    src[hub] = rng.randint(0, 3, len(hub))
    attr = (rng.rand(e) + 0.1).astype(np.float32)
    ei = np.stack([src, dst])
    pad_to = e + n + 13
    jg = JGraph.from_edges(ei, attr, n).with_self_loops().pad_edges_to(pad_to)
    pg = Graph.from_edges(ei, attr, n).with_self_loops().pad_edges_to(pad_to)
    if windowed:
        jg = jg.with_window_meta(Wb=128, nwin=2)
        pg = pg.with_window_meta(Wb=128, nwin=2)
        assert jg.winplan is not None and pg.winplan is not None
        assert pg.winplan.n_res > 0 and pg.winplan.n_tres > 0
    return n, jg.with_sorted_meta(), pg.with_sorted_meta("cpu")


def _jax_spmm_grad(jg, x_bnc, g_bnc, bf16):
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    jspmm.set_spmm_dtype(jnp.bfloat16 if bf16 else None)
    try:
        _, vjp = jax.vjp(
            lambda x: jspmm.gather_scatter(x, jg, "mean", edge_weight=jg.edge_attr),
            jnp.asarray(x_bnc),
        )
        (dx,) = vjp(jnp.asarray(g_bnc))
    finally:
        jspmm.set_backend(prev)
        jspmm.set_spmm_dtype(None)
    return np.asarray(dx, np.float64)


def _port_spmm_grad(pg, x_bnc, g_bnc, bf16):
    x = torch.from_numpy(np.ascontiguousarray(x_bnc.transpose(1, 0, 2)))
    x.requires_grad_(True)
    out = spmm.spmm_mean(x, pg, pg.edge_attr, dtype=torch.bfloat16 if bf16 else None)
    out.backward(torch.from_numpy(np.ascontiguousarray(g_bnc.transpose(1, 0, 2))))
    assert x.grad.dtype == torch.float32
    return x.grad.numpy().transpose(1, 0, 2).astype(np.float64)


@pytest.mark.parametrize("windowed", [False, True], ids=["composed", "windowed"])
def test_spmm_autograd_matches_jax_vjp(windowed):
    n, jg, pg = _graphs(windowed)
    rng = np.random.RandomState(41)
    x = rng.randn(3, n, 12).astype(np.float32)
    g = rng.randn(3, n, 12).astype(np.float32)
    j32 = _jax_spmm_grad(jg, x, g, bf16=False)
    _f32_close(_port_spmm_grad(pg, x, g, bf16=False), j32)
    j16 = _jax_spmm_grad(jg, x, g, bf16=True)
    _bf16_within(_port_spmm_grad(pg, x, g, bf16=True), j16, j32)


def test_spmm_backward_dtype_and_plain_switch():
    """The gradient comes back in x's dtype; under plain_versions() the
    backward takes the plain versions too, with the same result."""
    for windowed in (False, True):
        n, _, pg = _graphs(windowed)
        rng = np.random.RandomState(42)
        x0 = torch.from_numpy(rng.randn(n, 2, 8).astype(np.float32)).to(torch.bfloat16)
        g = torch.from_numpy(rng.randn(n, 2, 8).astype(np.float32))
        grads = []
        for plain in (False, True):
            x = x0.clone().requires_grad_(True)
            if plain:
                with spmm.plain_versions():
                    out = spmm.spmm_mean(x, pg, pg.edge_attr, dtype=torch.bfloat16)
            else:
                out = spmm.spmm_mean(x, pg, pg.edge_attr, dtype=torch.bfloat16)
            out.backward(g)
            assert x.grad.dtype == torch.bfloat16
            grads.append(x.grad.float())
        torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def gather_rows_grads():
    """(port dx, jax dx) of gather_rows with repeated ids and ids that were
    -1 before resolution, (B, N, C) layout, float64."""
    rng = np.random.RandomState(51)
    n, G = 90, 260
    match = rng.randint(-1, n, G)  # -1 = missing, resolved to the last slot
    match[:40] = rng.randint(0, 5, 40)  # repeated ids
    resolved = np.where(match >= 0, match, n + match)
    x = rng.randn(4, n, 6).astype(np.float32)
    g = rng.randn(4, G, 6).astype(np.float32)
    seg = SortedSegments.build(resolved, n)
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    try:
        _, vjp = jax.vjp(
            lambda a: jspmm.gather_rows(a, jnp.asarray(resolved, jnp.int32), seg),
            jnp.asarray(x),
        )
        (ref,) = vjp(jnp.asarray(g))
    finally:
        jspmm.set_backend(prev)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2))).requires_grad_(True)
    out = spmm.gather_rows(xt, torch.from_numpy(resolved), CSRPlan.gather(resolved, n))
    np.testing.assert_array_equal(out.detach().numpy(), xt.detach().numpy()[resolved])
    out.backward(torch.from_numpy(np.ascontiguousarray(g.transpose(1, 0, 2))))
    return (xt.grad.numpy().transpose(1, 0, 2).astype(np.float64),
            np.asarray(ref, np.float64))


def test_gather_rows_backward_matches_jax_vjp():
    dx, ref = gather_rows_grads()
    _f32_close(dx, ref)
    assert np.abs(ref[:, -1]).max() > 0  # the resolved -1 rows got their sum
