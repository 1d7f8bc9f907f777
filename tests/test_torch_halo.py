"""The port's boundary-only halo exchange (parallel/halo.py) on the CPU.

build_halo_partition's host arrays equal the JAX package's exactly
(senders_ext, receivers_loc, edge_sel, edge_mask, interior, send_idx,
deg and the statics), on tests/test_halo.py's community_graph at k = 4, a
ragged graph (N not a multiple of k) at k = 3 and 4, and the GBM-scale
cohort topology at k = 2 (host only).  Each rank's plans cover its edges
and carry its edges' weights.  In one process (k = 1), gather_scatter of a
graph with halo plans equals single device and refuses a weight that is
not the graph's own.

The aggregation on 4 gloo ranks, through spmm.gather_scatter of a rank's
graph carrying its halo plans (local_block, the exchange, all_gather_rows):
sum and mean, weighted or not, flat and windowed interiors, forward and
the input gradient (the ranks' shares summed), against the port's
single-device gather_scatter and the JAX package's halo_gather_scatter on
a 1 x 4 mesh of the conftest's virtual devices, within 1e-5.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multilevel_gnn_tpu.core.graph import Graph as JGraph
from multilevel_gnn_tpu.parallel import make_mesh
from multilevel_gnn_tpu.parallel import halo as JH
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.parallel import halo as PH
from multilevel_gnn_tpu_torch.parallel import scaling

import torch_parallel as TP
from torch_threads import few_threads  # noqa: F401  (autouse)

TOL = 1e-5
ARRAYS = ("senders_ext", "receivers_loc", "edge_sel", "edge_mask", "interior",
          "send_idx", "deg")
STATICS = ("k", "n_local", "halo", "n_edges_local", "n_nodes", "n_edges")
CASES = {
    f"{kind}-{reduce}{'-w' if w else ''}{'-win' if win else ''}":
        (kind, reduce, w, "halo_windowed" if win else "halo")
    for kind in ("community", "ragged")
    for reduce in ("sum", "mean")
    for w in (False, True)
    for win in (False, True)
}


def _same(jhp, php):
    for a in ARRAYS:
        np.testing.assert_array_equal(getattr(php, a), np.asarray(getattr(jhp, a)), err_msg=a)
    for s in STATICS:
        assert getattr(php, s) == getattr(jhp, s), s


@pytest.mark.parametrize("kind,k", [("community", 4), ("ragged", 3), ("ragged", 4),
                                    ("random", 2)])
def test_partition_arrays_equal_jax(kind, k):
    edges, attr, n = TP.graph_arrays(kind)
    _same(JH.build_halo_partition(JGraph.from_edges(edges, attr, n), k),
          PH.build_halo_partition(Graph.from_edges(edges, attr, n), k))


def test_partition_arrays_equal_jax_gbm_scale():
    """The bench's GBM-scale cohort topology (N = 15,405, E ~ 154k) at
    k = 2, on the host."""
    g = scaling.gbm_graph("cpu", windowed=False)
    send, recv = g.senders.numpy(), g.receivers.numpy()
    jg = JGraph.from_edges(np.stack([send, recv]), g.edge_attr.numpy(), g.n_nodes)
    np.testing.assert_array_equal(np.asarray(jg.senders), send)
    php = PH.build_halo_partition(g, 2)
    _same(JH.build_halo_partition(jg, 2), php)
    assert php.halo < php.n_local // 10  # the cohort topology is local


@pytest.mark.parametrize("windowed", [False, True])
def test_rank_plans_cover_the_edges(windowed):
    edges, attr, n = TP.graph_arrays("community")
    g = Graph.from_edges(edges, attr, n)
    hp = PH.build_halo_partition(g, 4, windowed=windowed)
    total = 0
    for p in range(4):
        rh = hp.for_rank(p, device="cpu", graph=g)
        assert rh.n_edges == int(hp.edge_mask[p].sum())
        # the rank's edge weights, selected once from the whole graph's
        whole = np.asarray(g.edge_attr).reshape(g.num_padded_edges, -1)[:, 0]
        np.testing.assert_array_equal(rh.edge_attr.numpy(),
                                      whole[hp.edge_sel[p, :rh.n_edges]])
        assert rh.gcn_coef is None and hp.for_rank(p, device="cpu").edge_attr is None
        assert rh.int_csr.nnz == rh.int_csc.nnz == rh.n_interior
        assert rh.bnd_csr.nnz == rh.bnd_csc.nnz == rh.n_boundary
        assert rh.send_plan.nnz == hp.k * hp.halo == rh.send_idx.shape[0]
        assert (rh.win is not None) == windowed
        if windowed:
            assert rh.win.num_nodes == hp.n_local and rh.win.n_edges == rh.n_edges
        total += rh.n_edges
    assert total == hp.n_edges


def test_rank_plans_default_to_cuda(monkeypatch):
    """A rank's plans go to the card unless the caller asks for the CPU:
    without CUDA, for_rank with no device raises."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges, attr, n = TP.graph_arrays("community")
    g = Graph.from_edges(edges, attr, n)
    hp = PH.build_halo_partition(g, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        hp.for_rank(0, graph=g)
    assert hp.for_rank(0, device="cpu", graph=g).deg.device.type == "cpu"


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_one_rank_halo_route(reduce):
    """spmm.gather_scatter of a graph carrying halo plans (k = 1, no
    group) takes the halo form, equal to single device with the graph's
    own weights, and refuses any other edge weight."""
    import torch

    from multilevel_gnn_tpu_torch.ops import spmm
    from multilevel_gnn_tpu_torch.parallel import mesh as PM

    g = TP.port_graph("ragged")
    rh = PH.build_halo_partition(g, 1).for_rank(0, device="cpu", graph=g)
    sg = dataclasses.replace(PM.edge_block(g, 1, 0), halo=rh)
    x = torch.tensor(TP.features("ragged", g.n_nodes)[0])
    np.testing.assert_allclose(spmm.gather_scatter(x, sg, reduce, sg.edge_attr).numpy(),
                               spmm.gather_scatter(x, g, reduce, g.edge_attr).numpy(),
                               rtol=TOL, atol=TOL)
    with pytest.raises(NotImplementedError):
        spmm.gather_scatter(x, sg, reduce, sg.edge_attr * 2.0)


@pytest.fixture(scope="module")
def ranks():
    return TP.run_ranks(TP.agg_rank, 4, CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_single_device(ranks, name):
    kind, reduce, w, _ = CASES[name]
    out, dx = ranks[0][name]
    want, want_dx = TP.single_agg(kind, reduce, w)
    np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dx, want_dx, rtol=TOL, atol=TOL)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name][0], out)


def _jax_halo(kind, reduce, weighted):
    edges, attr, n = TP.graph_arrays(kind)
    g = JGraph.from_edges(edges, attr, n)
    hp = JH.build_halo_partition(g, 4)
    mesh = make_mesh(1, 4)
    x, t = TP.features(kind, n)
    x, t = jnp.asarray(x.transpose(1, 0, 2)), jnp.asarray(t.transpose(1, 0, 2))
    w = g.edge_attr if weighted else None

    def agg(x):
        return JH.halo_gather_scatter(JH.pad_nodes_for(x, hp), hp, mesh, reduce, w)[:, :n]

    with mesh:
        out = jax.jit(agg)(x)
        dx = jax.jit(jax.grad(lambda x: jnp.sum(agg(x) * t)))(x)
    return np.asarray(out).transpose(1, 0, 2), np.asarray(dx).transpose(1, 0, 2)


@pytest.mark.parametrize("name", [n for n in CASES if not n.endswith("-win")])
def test_matches_jax(ranks, name):
    kind, reduce, w, _ = CASES[name]
    out, dx = ranks[0][name]
    want, want_dx = _jax_halo(kind, reduce, w)
    np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dx, want_dx, rtol=TOL, atol=TOL)
    # the windowed interior gives the same values
    np.testing.assert_allclose(ranks[0][name + "-win"][0], want, rtol=TOL, atol=TOL)
