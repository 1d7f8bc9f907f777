"""The fold-parallel step's stacked plans and the ops' torch.vmap rules, on
the CPU.

- Block-diagonal plans (CSRPlan.stack, WindowPlan.stack through
  core/graph.py:stack_graphs) over three graphs of different topologies
  and edge counts on one node count (N = 300, not a multiple of K2's
  128-row tile): the plain K1 (overwrite and accumulate), K2 (both sides,
  with the K1 residuals) and K3 versions over the stacked rows equal the
  concatenation of per-unit calls, exactly; stack_graphs refuses to mix a
  windowed graph with a composed one (ValueError naming the unit).
- torch.vmap over the port's ops (composed and windowed spmm_mean,
  gather_rows, edge_segment_sum, edge_segment_max, f32 and bf16) against
  jax.vmap of the JAX package's (pallas backend, interpret mode), values
  and VJPs: U = 3 units on one topology, each with its own features, edge
  weights and cotangent; and the same ops outside vmap (the sequential
  Functions after their setup_context rewrite) against JAX's un-vmapped
  ones.

Tolerances: stacked against per-unit, exact; against JAX,
max|port - jax| <= 1e-5 * max(1, max|jax|) in f32, and in bf16 the
port's f32 reading within 1.5x JAX bf16's own error plus 1e-3
(test_torch_backward.py's bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.graph import Graph as JGraph
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu.ops.pallas.segment_sum import SortedSegments
from multilevel_gnn_tpu_torch.core.graph import Graph, stack_graphs
from multilevel_gnn_tpu_torch.ops import spmm
from multilevel_gnn_tpu_torch.ops.kernels import segment_max as K3
from multilevel_gnn_tpu_torch.ops.kernels import segment_sum as K1
from multilevel_gnn_tpu_torch.ops.kernels import windowed as K2
from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import CSRPlan

from torch_threads import few_threads  # noqa: F401  (autouse)

N, U, F = 300, 3, 16


def _edges(seed, e):
    """Banded edges with a few hub sources: windows hold most of them, the
    rest are residual."""
    rng = np.random.RandomState(seed)
    s = rng.randint(0, N, e)
    d = np.clip(s + rng.randint(-40, 41, e), 0, N - 1)
    s[: e // 10] = rng.randint(0, 3, e // 10)
    return np.stack([s, d]), (rng.rand(e) + 0.1).astype(np.float32)


def _graph(seed, e, windowed, pad=None):
    ei, attr = _edges(seed, e)
    g = Graph.from_edges(ei, attr, N).with_self_loops()
    g = g.pad_edges_to(pad if pad is not None else g.n_edges + 7)
    if windowed:
        g = g.with_window_meta(Wb=128, nwin=2, min_frac=0.0)
        assert g.winplan is not None
    return g.with_sorted_meta("cpu")


def _units(windowed):
    return [_graph(10 + u, 900 + 150 * u, windowed) for u in range(U)]


def _rows(n, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.RandomState(seed).randn(n, F).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stacked_k1_k3_plain_equal_per_unit(dtype):
    graphs = _units(False)
    sg = stack_graphs(graphs)
    E = sg.fields["senders"].shape[1]
    x = _rows(U * N, 1, dtype)
    w = torch.from_numpy(np.random.RandomState(2).rand(U * E).astype(np.float32))
    msg = _rows(U * E, 3, dtype)
    for attr, cols in (("csr", x), ("csc", x), ("src_gather", msg), ("dst_gather", msg)):
        plan = getattr(sg.view, attr)
        n_cols = cols.shape[0] // U
        want = torch.cat([K1.segment_spmm_csr_plain(
            cols[u * n_cols:(u + 1) * n_cols], w[u * E:(u + 1) * E], getattr(g, attr))
            for u, g in enumerate(graphs)])
        assert torch.equal(K1.segment_spmm_csr_plain(cols, w, plan), want), attr
        assert torch.equal(K1.segment_spmm_csr(cols, w, plan), want), attr
        base = _rows(U * N, 4)
        acc = K1.segment_spmm_csr(cols, w, plan, out=base.clone())
        assert torch.equal(acc, base + want), attr
    want = torch.cat([K3.segment_max_csr_plain(msg[u * E:(u + 1) * E], g.csr)
                      for u, g in enumerate(graphs)])
    assert torch.equal(K3.segment_max_csr_plain(msg, sg.view.csr), want)
    assert torch.equal(K3.segment_max_csr(msg, sg.view.csr), want)


@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "transpose"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stacked_k2_plain_equals_per_unit(dtype, transpose):
    graphs = _units(True)
    sg = stack_graphs(graphs)
    plan = sg.view.winplan
    E = sg.fields["senders"].shape[1]
    assert plan.num_nodes == U * N and plan.n_edges == U * E
    assert plan.row_of.shape[0] == U * 384  # N rounded up to whole tiles
    x = _rows(U * N, 5, dtype)
    w = torch.from_numpy(np.random.RandomState(6).rand(U * E).astype(np.float32))
    for fn in (K2.windowed_tile_spmm_plain, K2.windowed_spmm_plain, K2.windowed_spmm):
        want = torch.cat([fn(x[u * N:(u + 1) * N], w[u * E:u * E + g.num_padded_edges],
                             g.winplan, transpose) for u, g in enumerate(graphs)])
        assert torch.equal(fn(x, w, plan, transpose), want), fn.__name__


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stack_shifts_chunk_lists(dtype):
    """CSRPlan.stack shifts split_rows by the unit's rows, chunk_row by the
    earlier units' split slots and chunk_ptr by their chunk slots, as it
    shifts long_rows, over host-built plans and a device-built one (padded
    with -1); the card's order of additions over the stacked plan equals
    each unit's own, bit for bit."""
    from test_torch_segment_sum import _check_classes, _hub_entries, _kernel_order

    plans = []
    for u in range(U):
        rows, n = _hub_entries(60 + u, n_rows=N, hubs=(700 + 300 * u, 90, 600))
        E = len(rows)
        cols = np.random.RandomState(u).randint(0, N, E)
        build = CSRPlan.on_device if u == 1 else (
            lambda r, c, e, n_rows, _: CSRPlan.build(r.numpy(), c.numpy(), e.numpy(), n_rows))
        plans.append(build(torch.from_numpy(rows), torch.from_numpy(cols), torch.arange(E),
                           N, N - 1))
    Emax = max(p.nnz for p in plans)
    sp = CSRPlan.stack(plans, N, Emax)
    _check_classes(sp)
    for attr, stride in (("long_rows", N), ("split_rows", N)):
        want = torch.cat([torch.where(getattr(p, attr) >= 0, getattr(p, attr) + u * stride, -1)
                          for u, p in enumerate(plans)]).int()
        assert torch.equal(getattr(sp, attr), want), attr
    c_off = np.cumsum([0] + [p.chunk_row.shape[0] for p in plans])
    s_off = np.cumsum([0] + [p.split_rows.shape[0] for p in plans])
    for u, p in enumerate(plans):
        S = p.split_rows.shape[0]
        assert torch.equal(sp.chunk_ptr[s_off[u]:s_off[u] + S], p.chunk_ptr[:-1] + int(c_off[u]))
        cr = sp.chunk_row[c_off[u]:c_off[u + 1]]
        assert torch.equal(cr, torch.where(p.chunk_row >= 0, p.chunk_row + int(s_off[u]), -1))
    assert sp.chunk_ptr[-1] == plans[-1].chunk_ptr[-1] + int(c_off[-2])
    x = _rows(U * N, 8, dtype)
    w = torch.from_numpy(np.random.RandomState(9).rand(U * Emax).astype(np.float32))
    want = torch.cat([_kernel_order(x[u * N:(u + 1) * N], w[u * Emax:(u + 1) * Emax], p)
                      for u, p in enumerate(plans)])
    assert torch.equal(_kernel_order(x, w, sp), want)


def test_stack_graphs_refuses_mixed_paths():
    graphs = _units(False)
    graphs[2] = _graph(12, 1200, True)
    with pytest.raises(ValueError, match="unit 2.*windowed"):
        stack_graphs(graphs)
    with pytest.raises(ValueError, match="run 0 fold 2"):
        stack_graphs(graphs, [f"run 0 fold {u}" for u in range(U)])


# ---- torch.vmap over the ops against jax.vmap

def _pair(windowed):
    """One topology on both sides (JAX stacks structurally identical
    graphs), with padding edges."""
    ei, attr = _edges(21, 1000)
    jg = JGraph.from_edges(ei, attr, N).with_self_loops().pad_edges_to(1320)
    pg = Graph.from_edges(ei, attr, N).with_self_loops().pad_edges_to(1320)
    if windowed:
        jg = jg.with_window_meta(Wb=128, nwin=2)
        pg = pg.with_window_meta(Wb=128, nwin=2)
        assert pg.winplan is not None and pg.winplan.n_res > 0
    return jg.with_sorted_meta(), pg.with_sorted_meta("cpu")


def _jax_pallas(fn):
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    try:
        return fn()
    finally:
        jspmm.set_backend(prev)
        jspmm.set_spmm_dtype(None)


def _close(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    err = np.abs(out - ref).max() if out.size else 0.0
    assert err <= 1e-5 * max(1.0, np.abs(ref).max()), err


def _within(p16, j16, j32):
    p16, j16, j32 = (np.asarray(a, np.float64) for a in (p16, j16, j32))
    assert np.abs(p16 - j32).max() <= 1.5 * np.abs(j16 - j32).max() + 1e-3


def _port(fn, pg, args, g, vmapped):
    """(out, grads of args) of fn(unit graph, *args) under torch.vmap over
    U units of pg (stack_graphs of U copies), or per unit when not
    vmapped; args and g are (U, ...) tensors."""
    args = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
    if vmapped:
        sg = stack_graphs([pg] * U)
        out = torch.vmap(lambda f, *a: fn(sg.unit(f), *a))(sg.fields, *args)
    else:
        out = torch.stack([fn(pg, *(a[u] for a in args)) for u in range(U)])
    out.backward(g)
    return out.detach(), [a.grad for a in args if a.requires_grad]


def _bnc(t):
    """(U, M, B, C) port layout -> (U, B, M, C) JAX layout."""
    return np.swapaxes(t.float().numpy(), 1, 2)


@pytest.mark.parametrize("vmapped", [True, False], ids=["vmap", "per_unit"])
@pytest.mark.parametrize("windowed", [False, True], ids=["composed", "windowed"])
def test_spmm_mean_matches_jax_vmap(windowed, vmapped):
    jg, pg = _pair(windowed)
    E = pg.num_padded_edges
    rng = np.random.RandomState(31)
    x = rng.randn(U, 2, N, 6).astype(np.float32)
    w = (rng.rand(U, E, 1) + 0.5).astype(np.float32)
    g = rng.randn(U, 2, N, 6).astype(np.float32)

    def jax_run(bf16):
        jspmm.set_spmm_dtype(jnp.bfloat16 if bf16 else None)
        f = jax.vmap(lambda a, b: jspmm.gather_scatter(a, jg, "mean", edge_weight=b))
        out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
        return (out,) + vjp(jnp.asarray(g))

    j32 = _jax_pallas(lambda: jax_run(False))
    j16 = _jax_pallas(lambda: jax_run(True))
    xt = torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 1, 2)))
    gt = torch.from_numpy(np.ascontiguousarray(np.swapaxes(g, 1, 2)))
    wt = torch.from_numpy(w)
    for bf16, ref in ((False, j32), (True, j16)):
        dt = torch.bfloat16 if bf16 else None
        out, (dx, dw) = _port(lambda gr, a, b: spmm.spmm_mean(a, gr, b, dtype=dt),
                              pg, [xt, wt], gt, vmapped)
        if bf16:
            _within(_bnc(out), ref[0], j32[0])
            _within(_bnc(dx), ref[1], j32[1])
        else:
            _close(_bnc(out), ref[0])
            _close(_bnc(dx), ref[1])
    assert dw is None  # edge weights are data: no gradient, as in JAX


@pytest.mark.parametrize("vmapped", [True, False], ids=["vmap", "per_unit"])
def test_gather_rows_matches_jax_vmap(vmapped):
    rng = np.random.RandomState(41)
    G = 260
    match = rng.randint(-1, N, (U, G))
    match[:, :40] = rng.randint(0, 5, (U, 40))  # repeated ids
    resolved = np.where(match >= 0, match, N + match)
    x = rng.randn(U, 2, N, 6).astype(np.float32)
    g = rng.randn(U, 2, G, 6).astype(np.float32)
    segs = [SortedSegments.build(r, N) for r in resolved]

    def jax_run():
        outs, dxs = [], []
        # JAX's plans differ per unit here, so each unit is vmapped alone
        # over a unit axis of one
        for u in range(U):
            f = jax.vmap(lambda a, u=u: jspmm.gather_rows(
                a, jnp.asarray(resolved[u], jnp.int32), segs[u]))
            out, vjp = jax.vjp(f, jnp.asarray(x[u:u + 1]))
            outs.append(out[0])
            dxs.append(vjp(jnp.asarray(g[u:u + 1]))[0][0])
        return np.stack(outs), np.stack(dxs)

    jo, jd = _jax_pallas(jax_run)
    plans = [CSRPlan.gather(r, N) for r in resolved]
    idx = torch.from_numpy(resolved)
    xt = torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 1, 2))).requires_grad_(True)
    if vmapped:
        seg = CSRPlan.stack(plans, G, G)
        out = torch.vmap(lambda a, i: spmm.gather_rows(a, i, seg))(xt, idx)
    else:
        out = torch.stack([spmm.gather_rows(xt[u], idx[u], plans[u]) for u in range(U)])
    out.backward(torch.from_numpy(np.ascontiguousarray(np.swapaxes(g, 1, 2))))
    _close(_bnc(out.detach()), jo)
    _close(_bnc(xt.grad), jd)


@pytest.mark.parametrize("vmapped", [True, False], ids=["vmap", "per_unit"])
@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_segment_ops_match_jax_vmap(reduce, dtype, vmapped):
    jg, pg = _pair(False)
    E = pg.num_padded_edges
    rng = np.random.RandomState(51)
    msg = rng.randn(U, 2, E, 6).astype(np.float32)
    if reduce == "max":
        msg = np.round(msg * 4) / 4  # ties: each tied edge gets the cotangent
    g = rng.randn(U, 2, N, 6).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jfn = jspmm.edge_segment_sum if reduce == "sum" else jspmm.edge_segment_max

    def jax_run():
        f = jax.vmap(lambda m: jfn(m, jg.receivers, jg.edge_mask, jg.csr))
        out, vjp = jax.vjp(f, jnp.asarray(msg, jdt))
        return out, vjp(jnp.asarray(g))[0]

    jo, jd = _jax_pallas(jax_run)
    mt = torch.from_numpy(np.ascontiguousarray(np.swapaxes(msg, 1, 2))).to(getattr(torch, dtype))

    def port(gr, m):
        if reduce == "sum":
            return spmm.edge_segment_sum(m, gr)
        return spmm.edge_segment_max(m, gr.receivers, gr.edge_mask, gr.csr)

    out, (dm,) = _port(port, pg, [mt], torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(g, 1, 2))), vmapped)
    assert out.dtype == torch.float32 and dm.dtype == mt.dtype
    _close(_bnc(out), np.asarray(jo, np.float32))
    _close(_bnc(dm), np.asarray(jd, np.float32))
