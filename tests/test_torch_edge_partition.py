"""The port's edge-partitioned aggregation (parallel/edge_partition.py) on
4 gloo ranks of the CPU: sum, mean, max and min through
spmm.gather_scatter of a rank's edge block (mesh.edge_block), forward
and the input gradient (the ranks' shares summed), against the port's
single-device gather_scatter and the JAX package's
edge_partitioned_gather_scatter on a 1 x 4 mesh of the conftest's virtual
devices, within 1e-5 (JAX's max form only forward: jax.lax.pmax has no
differentiation rule, so JAX's function cannot give its gradient).  The
graphs include one whose maxima tie across
ranks (every tied edge takes the whole cotangent, as on one device) and
one with negative maxima on rows that some ranks hold no edge of (the
-inf fill before the MAX all-reduce).  Also the ranks' outputs equal
each other exactly, and edge_block's plans and coefficients.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multilevel_gnn_tpu.core.batch import make_fold_context
from multilevel_gnn_tpu.core.graph import Graph as JGraph
from multilevel_gnn_tpu.parallel import make_mesh, shard_ctx
from multilevel_gnn_tpu.parallel.edge_partition import edge_partitioned_gather_scatter
from multilevel_gnn_tpu_torch.parallel import mesh as PM

import torch_parallel as TP
from torch_threads import few_threads  # noqa: F401  (autouse)

TOL = 1e-5
CASES = {
    "random-sum-w": ("random", "sum", True),
    "random-mean-w": ("random", "mean", True),
    "random-max-w": ("random", "max", True),
    "random-min": ("random", "min", False),
    "random-sum": ("random", "sum", False),
    "ties-max": ("ties", "max", False),
    "ties-min": ("ties", "min", False),
    "negative-max-w": ("negative", "max", True),
    "negative-max": ("negative", "max", False),
    "negative-mean": ("negative", "mean", False),
}
JAX_CASES = [n for n, c in CASES.items() if c[1] != "min"]


@pytest.fixture(scope="module")
def ranks():
    cases = {n: c + ("edge",) for n, c in CASES.items()}
    return TP.run_ranks(TP.agg_rank, 4, cases)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_single_device(ranks, name):
    out, dx = ranks[0][name]
    want, want_dx = TP.single_agg(*CASES[name])
    np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dx, want_dx, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_agree(ranks, name):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name][0], ranks[0][name][0])
        np.testing.assert_array_equal(r[name][1], ranks[0][name][1])


def _jax_agg(kind, reduce, weighted):
    edges, attr, n = TP.graph_arrays(kind)
    g = JGraph.from_edges(edges, attr, n)
    mesh = make_mesh(1, 4)
    ctx = shard_ctx(make_fold_context(g, np.zeros(4, np.int32), np.zeros(4, np.int32),
                                      n_pathways=1), mesh)
    gs = ctx.graph
    x, t = TP.features(kind, n)
    x, t = jnp.asarray(x.transpose(1, 0, 2)), jnp.asarray(t.transpose(1, 0, 2))
    w = gs.edge_attr if weighted else None

    def agg(x):
        return edge_partitioned_gather_scatter(x, gs, mesh, reduce, w)

    with mesh:
        out = jax.jit(agg)(x)
        dx = None if reduce == "max" else jax.jit(
            jax.grad(lambda x: jnp.sum(agg(x) * t)))(x)
    tr = (lambda a: np.asarray(a).transpose(1, 0, 2))
    return tr(out), (tr(dx) if dx is not None else None)


@pytest.mark.parametrize("name", JAX_CASES)
def test_matches_jax(ranks, name):
    out, dx = ranks[0][name]
    want, want_dx = _jax_agg(*CASES[name])
    np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
    if want_dx is not None:
        np.testing.assert_allclose(dx, want_dx, rtol=TOL, atol=TOL)


def test_negative_rows_empty_on_some_ranks():
    """The negative graph is the max form's trap: rows whose maximum is
    negative and that some ranks hold no edge of."""
    g = TP.port_graph("negative")
    seen = np.zeros((4, g.n_nodes), bool)
    for r in range(4):
        b = PM.edge_block(g, 4, r)
        lens = np.diff(b.csr.rowptr.numpy())
        seen[r] = lens > 0
    has = seen.any(0)
    assert (has & ~seen.all(0)).sum() > 10


@pytest.mark.parametrize("n_model", [3, 4])
def test_edge_block_plans_and_coefficients(n_model):
    """Each rank's plans cover exactly its block's real edges; the whole
    graph's in-degree and GCN coefficients are kept, sliced, not
    recomputed from the block."""
    g = TP.port_graph("ragged")
    Ep = -(-g.num_padded_edges // n_model) * n_model
    coefs, blocks = [], []
    for r in range(n_model):
        b = PM.edge_block(g, n_model, r)
        assert b.num_padded_edges == Ep // n_model and b.winplan is None
        assert b.shard.offset == r * (Ep // n_model) and b.shard.n_padded == Ep
        assert b.csr.nnz == b.csc.nnz == int(b.edge_mask.sum()) == b.n_edges
        assert b.in_deg is g.in_deg and b.gcn_self is g.gcn_self
        coefs.append(b.gcn_coef)
        blocks.append(b.receivers[b.edge_mask])
    coef = np.concatenate([c.numpy() for c in coefs])
    np.testing.assert_array_equal(coef[: g.num_padded_edges], g.gcn_coef.numpy())
    assert not coef[g.num_padded_edges:].any()
    np.testing.assert_array_equal(np.concatenate([b.numpy() for b in blocks]),
                                  g.receivers[g.edge_mask].numpy())


def test_scaling_bench_harness():
    """scaling_bench times make_fn(n) at each size and reports each size's
    efficiency against the first (JAX's edge_partition.py:95-116)."""
    from multilevel_gnn_tpu_torch.parallel.edge_partition import scaling_bench

    calls = []

    def make_fn(n):
        return lambda v: calls.append((n, v))

    secs, eff = scaling_bench([1, 2, 4], make_fn, 7, iters=3)
    assert sorted(secs) == [1, 2, 4] and eff[1] == 1.0
    assert all(s > 0 for s in secs.values())
    assert calls == [(n, 7) for n in (1, 2, 4) for _ in range(4)]
    for n in (2, 4):
        assert eff[n] == pytest.approx(secs[1] / (secs[n] * n))
