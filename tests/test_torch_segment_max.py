"""K3 (CSR segment-max, ops/kernels/segment_max.py) of the PyTorch port
against the JAX package's pallas backend.

- The kernel's plain version (segment_max_csr on CPU tensors, over the
  graph's csr plan) against segment_max_by, which runs flat_segment_max in
  interpret mode, on random graphs with empty rows, graphs without self
  loops and masked padding edges whose rows hold large values; bf16 and
  f32 rows.  ops/segment.segment_max / segment_min against the JAX XLA
  segment_max / segment_min with the mask.
- edge_segment_max / edge_segment_min: forward and gradient against
  jax.vjp of the JAX custom VJPs, on values drawn from a few integers so
  that most segments have exact ties (each tied edge gets the full
  cotangent), padding edges included; bf16 and f32.
- gather_scatter with reduce max / min and edge weights (gather_src's
  backward: K1 over src_gather) against jax.vjp of JAX gather_scatter.
- The edge gathers' plans hold each real edge once, grouped by sender /
  receiver.

Tolerances: every maximum, minimum and K3 gradient is equal (max abs
error 0: the max selects one of its inputs, and the gradient copies the
cotangent).  Gradients that go through gather_src's backward sum f32 rows
in another order: 1e-5 * max(1, max|ref|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.graph import Graph as JGraph
from multilevel_gnn_tpu.ops import segment as jseg
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu.ops.pallas import segment_max as pmax
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.ops import segment as pseg
from multilevel_gnn_tpu_torch.ops import spmm
from multilevel_gnn_tpu_torch.ops.kernels.segment_max import segment_max_csr

CASES = [
    # seed, n, e, pad, empty_tail, self_loops
    (0, 200, 1400, 0, 0, True),
    (1, 157, 900, 37, 20, False),
    (2, 130, 400, 90, 60, False),
]
IDS = ["loops", "empty_rows_padded", "sparse_padded"]


def _graphs(case):
    seed, n, e, pad, tail, loops = case
    rng = np.random.RandomState(seed)
    ei = np.stack([rng.randint(0, n, e), rng.randint(0, n - tail, e)])
    attr = (rng.rand(e) + 0.1).astype(np.float32)
    jg, pg = JGraph.from_edges(ei, attr, n), Graph.from_edges(ei, attr, n)
    if loops:
        jg, pg = jg.with_self_loops(), pg.with_self_loops()
    pad_to = jg.n_edges + pad
    jg = jg.pad_edges_to(pad_to).with_sorted_meta()
    pg = pg.pad_edges_to(pad_to).with_sorted_meta("cpu")
    return n, jg, pg


def _rows(pg, F, seed, ties=False):
    """(E_pad, F) float32 edge rows; padding rows hold 1e4, above any real
    value, so a padding edge that reached the max would show."""
    rng = np.random.RandomState(seed)
    E = pg.num_padded_edges
    v = rng.randint(-3, 4, (E, F)) * 0.5 if ties else rng.randn(E, F) * 3
    v = v.astype(np.float32)
    v[~pg.edge_mask.numpy()] = 1e4
    return v


@pytest.fixture(autouse=True)
def _pallas():
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    yield
    jspmm.set_backend(prev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k3_plain_equals_jax_segment_max_by(case, dtype):
    n, jg, pg = _graphs(case)
    data = _rows(pg, 20, seed=case[0])
    jt = jnp.asarray(data, getattr(jnp, dtype))
    ref = np.asarray(jax.jit(lambda a: pmax.segment_max_by(a, jg.csr))(jt), np.float64)
    out = segment_max_csr(torch.from_numpy(data).to(getattr(torch, dtype)), pg.csr)
    assert out.dtype == torch.float32 and out.shape == (n, 20)
    np.testing.assert_array_equal(out.numpy().astype(np.float64), ref)
    empty = np.bincount(pg.receivers.numpy()[pg.edge_mask.numpy()], minlength=n) == 0
    assert case[4] == 0 or empty.any()
    assert (out.numpy()[empty] == 0).all()
    assert out.numpy().max() < 1e4  # no padding edge reached a max


@pytest.mark.parametrize("case", CASES[1:], ids=IDS[1:])
def test_segment_extremes_equal_jax(case):
    n, jg, pg = _graphs(case)
    data = _rows(pg, 6, seed=5)
    recv, mask = pg.receivers.numpy(), pg.edge_mask.numpy()
    for pf, jf in ((pseg.segment_max, jseg.segment_max),
                   (pseg.segment_min, jseg.segment_min)):
        ref = np.asarray(jf(jnp.asarray(data), jnp.asarray(recv), n,
                            axis=0, mask=jnp.asarray(mask)))
        out = pf(torch.from_numpy(data[mask]), torch.from_numpy(recv[mask]), n)
        np.testing.assert_array_equal(out.numpy(), ref)


def _esm_jax(fn, m, g, jg):
    def f(a, c):
        out, vjp = jax.vjp(lambda a: fn(a, jg.receivers, jg.edge_mask, jg.csr), a)
        return out, vjp(c)[0]

    out, d = jax.jit(f)(m, g)
    return np.asarray(out, np.float64), np.asarray(d, np.float64)


def _esm_port(fn, m, g, pg):
    mt = m.clone().requires_grad_(True)
    out = fn(mt, pg.receivers, pg.edge_mask, pg.csr)
    out.backward(g)
    assert out.dtype == torch.float32 and mt.grad.dtype == m.dtype
    return (out.detach().numpy().astype(np.float64),
            mt.grad.float().numpy().astype(np.float64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_edge_segment_max_grad_equals_jax_vjp_with_ties(case, dtype):
    n, jg, pg = _graphs(case)
    B, C = 2, 5
    E = pg.num_padded_edges
    m = _rows(pg, B * C, seed=7, ties=True).reshape(E, B, C)
    g = np.random.RandomState(8).randn(n, B, C).astype(np.float32)
    jm = jnp.asarray(m.transpose(1, 0, 2), getattr(jnp, dtype))  # (B, E, C)
    jgrad = jnp.asarray(g.transpose(1, 0, 2))
    pm = torch.from_numpy(m).to(getattr(torch, dtype))
    for jf, pf in ((jspmm.edge_segment_max, spmm.edge_segment_max),
                   (jspmm.edge_segment_min, spmm.edge_segment_min)):
        jo, jd = _esm_jax(jf, jm, jgrad, jg)
        po, pd = _esm_port(pf, pm, torch.from_numpy(g), pg)
        np.testing.assert_array_equal(po.transpose(1, 0, 2), jo)
        np.testing.assert_array_equal(pd.transpose(1, 0, 2), jd)
        # ties: more edges got a cotangent than there are (row, feature)
        # pairs with entries, and no padding edge got one
        assert np.count_nonzero(pd) > np.count_nonzero(po)
        assert not pd[~pg.edge_mask.numpy()].any()


@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_gather_scatter_max_min_matches_jax(case, reduce):
    n, jg, pg = _graphs(case)
    rng = np.random.RandomState(9)
    x = rng.randn(3, n, 4).astype(np.float32)
    g = rng.randn(3, n, 4).astype(np.float32)

    def f(a, c):
        out, vjp = jax.vjp(
            lambda a: jspmm.gather_scatter(a, jg, reduce, edge_weight=jg.edge_attr), a)
        return out, vjp(c)[0]

    out, jdx = jax.jit(f)(jnp.asarray(x), jnp.asarray(g))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2))).requires_grad_(True)
    po = spmm.gather_scatter(xt, pg, reduce, edge_weight=pg.edge_attr)
    po.backward(torch.from_numpy(np.ascontiguousarray(g.transpose(1, 0, 2))))
    np.testing.assert_array_equal(po.detach().numpy().transpose(1, 0, 2),
                                  np.asarray(out))
    ref = np.asarray(jdx, np.float64)
    dx = xt.grad.numpy().transpose(1, 0, 2)
    assert np.abs(dx - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


def test_edge_gather_plans_cover_real_edges():
    n, _, pg = _graphs(CASES[1])
    mask = pg.edge_mask.numpy()
    real = np.flatnonzero(mask)
    for plan, ids in ((pg.src_gather, pg.senders), (pg.dst_gather, pg.receivers)):
        np.testing.assert_array_equal(np.sort(plan.col.numpy()), real)
        np.testing.assert_array_equal(plan.eid.numpy(), plan.col.numpy())
        np.testing.assert_array_equal(plan.row.numpy(), ids.numpy()[plan.col.numpy()])
        assert plan.n_rows == n and (np.diff(plan.row.numpy()) >= 0).all()
