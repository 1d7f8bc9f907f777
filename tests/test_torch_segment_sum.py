"""K1 (weighted CSR segment-sum, ops/kernels/segment_sum.py) of the PyTorch
port against the JAX package's pallas backend.

The port's spmm_sum / spmm_mean (plain versions, CPU, no window plan: K1
over all real edges) against JAX gather_scatter on the 'pallas' backend
(_fused_spmm_sum: row gather + flat_segment_sum in interpret mode), on
random graphs with empty segments and padding edges.

Tolerances:
  f32:  rtol = atol = 1e-5.
  bf16: max|port_bf16 - jax_bf16| <= 1e-5 * max(1, max|jax_bf16|): both
        round each edge weight to bf16, so both sum the same exact f32
        products, in different orders.  The bound against JAX f32,
        max|port_bf16 - jax_f32| <= 1.5 * max|jax_bf16 - jax_f32| + 1e-3,
        stays as its own test.
The CSR plan and the kernel's plain version are also checked against a
float64 loop oracle (rtol = atol = 1e-5), the plan's row lists against
the rows they must cover, and spmm.plain_versions() for dispatch (its
result against the default path: rtol = atol = 1e-6).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multilevel_gnn_tpu.core.graph import Graph as JGraph
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.ops import spmm
from multilevel_gnn_tpu_torch.ops.kernels import segment_sum as k1
from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import (
    CSRPlan,
    segment_spmm_csr,
    segment_spmm_csr_plain,
)


def _graph(seed, n, e, pad, empty_tail=0):
    """Random edges over the first n - empty_tail nodes (the tail nodes get
    no in-edges: empty segments), padded by `pad` masked edges."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, n, e)
    dst = rng.randint(0, n - empty_tail, e)
    attr = rng.rand(e).astype(np.float32) + 0.1
    ei = np.stack([src, dst])
    return ei, attr, n, e + pad


def _jax_spmm(ei, attr, n, pad_to, x_bnc, reduce, bf16):
    g = JGraph.from_edges(ei, attr, n, pad_to=pad_to).with_sorted_meta()
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    jspmm.set_spmm_dtype(jnp.bfloat16 if bf16 else None)
    try:
        out = jspmm.gather_scatter(
            jnp.asarray(x_bnc), g, reduce, edge_weight=g.edge_attr
        )
    finally:
        jspmm.set_backend(prev)
        jspmm.set_spmm_dtype(None)
    return np.asarray(out, np.float64)


def _port_spmm(ei, attr, n, pad_to, x_bnc, reduce, bf16):
    g = Graph.from_edges(ei, attr, n, pad_to=pad_to).with_sorted_meta("cpu")
    x = torch.from_numpy(np.ascontiguousarray(x_bnc.transpose(1, 0, 2)))
    out = spmm.gather_scatter(
        x, g, reduce, edge_weight=g.edge_attr,
        dtype=torch.bfloat16 if bf16 else None,
    )
    assert out.dtype == torch.float32
    return out.numpy().transpose(1, 0, 2).astype(np.float64)


CASES = [
    # seed, n, e, pad, empty_tail
    (0, 300, 1500, 0, 0),
    (1, 257, 900, 37, 20),
    (2, 130, 400, 100, 60),
]


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("case", CASES)
def test_k1_spmm_f32_matches_jax_pallas(case, reduce):
    seed, n, e, pad, tail = case
    ei, attr, n, pad_to = _graph(seed, n, e, pad, tail)
    x = np.random.RandomState(seed + 10).randn(3, n, 16).astype(np.float32)
    ref = _jax_spmm(ei, attr, n, pad_to, x, reduce, bf16=False)
    out = _port_spmm(ei, attr, n, pad_to, x, reduce, bf16=False)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    if tail:
        assert np.all(out[:, n - tail :] == 0.0)  # empty segments give 0


@pytest.mark.parametrize("case", CASES[:2])
def test_k1_spmm_bf16_within_bound(case):
    seed, n, e, pad, tail = case
    ei, attr, n, pad_to = _graph(seed, n, e, pad, tail)
    x = np.random.RandomState(seed + 20).randn(2, n, 24).astype(np.float32)
    j32 = _jax_spmm(ei, attr, n, pad_to, x, "mean", bf16=False)
    j16 = _jax_spmm(ei, attr, n, pad_to, x, "mean", bf16=True)
    p16 = _port_spmm(ei, attr, n, pad_to, x, "mean", bf16=True)
    bound = 1.5 * np.abs(j16 - j32).max() + 1e-3
    assert np.abs(p16 - j32).max() <= bound


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("case", CASES)
def test_k1_spmm_bf16_matches_jax_bf16(case, reduce):
    seed, n, e, pad, tail = case
    ei, attr, n, pad_to = _graph(seed, n, e, pad, tail)
    x = np.random.RandomState(seed + 30).randn(3, n, 16).astype(np.float32)
    ref = _jax_spmm(ei, attr, n, pad_to, x, reduce, bf16=True)
    out = _port_spmm(ei, attr, n, pad_to, x, reduce, bf16=True)
    assert np.abs(out - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


def _oracle(x, w, rows, cols, eids, n_rows):
    out = np.zeros((n_rows, x.shape[1]), np.float64)
    for r, c, e in zip(rows, cols, eids):
        out[r] += x[c].astype(np.float64) * w[e]
    return out


def test_csr_plan_and_plain_accumulate():
    rng = np.random.RandomState(3)
    n_rows, n_x, E = 50, 40, 300
    rows = rng.randint(0, n_rows - 5, E)  # last rows empty
    cols = rng.randint(0, n_x, E)
    keep = rng.rand(E) > 0.2
    eids = np.flatnonzero(keep)
    plan = CSRPlan.build(rows[eids], cols[eids], eids, n_rows)
    assert plan.nnz == len(eids)
    rp = plan.rowptr.numpy()
    assert rp[0] == 0 and rp[-1] == plan.nnz and np.all(np.diff(rp) >= 0)
    assert np.all(plan.row.numpy() == np.repeat(np.arange(n_rows), np.diff(rp)))
    x = rng.randn(n_x, 12).astype(np.float32)
    w = rng.randn(E).astype(np.float32)
    ref = _oracle(x, w, rows[eids], cols[eids], eids, n_rows)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    out = segment_spmm_csr(xt, wt, plan)  # CPU tensor: plain version
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    base = torch.from_numpy(rng.randn(n_rows, 12).astype(np.float32))
    acc = segment_spmm_csr_plain(xt, wt, plan, out=base.clone())
    np.testing.assert_allclose(acc.numpy(), ref + base.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("long_rows", [0, 3])
def test_csr_row_lists_cover_rows(long_rows):
    """items lists the rows with 1..LONG_ROW entries first (n_busy of them),
    then the empty rows; long_rows the longer ones; each row once."""
    rng = np.random.RandomState(4 + long_rows)
    n_rows = 200
    rows = rng.randint(0, n_rows - 30, 900)  # the last 30 rows stay empty
    hubs = np.repeat(rng.choice(n_rows - 30, long_rows, replace=False),
                     k1.LONG_ROW + 1 + rng.randint(0, 500, long_rows))
    rows = np.concatenate([rows, hubs])
    plan = CSRPlan.build(rows, rng.randint(0, 50, len(rows)), np.arange(len(rows)), n_rows)
    lens = np.diff(plan.rowptr.numpy())
    items, longs = plan.items.numpy(), plan.long_rows.numpy()
    busy = items[: plan.n_busy]
    np.testing.assert_array_equal(np.sort(np.concatenate([items, longs])), np.arange(n_rows))
    assert np.all((lens[busy] > 0) & (lens[busy] <= k1.LONG_ROW))
    assert np.all(lens[items[plan.n_busy:]] == 0) and np.all(lens[longs] > k1.LONG_ROW)
    assert len(longs) == long_rows
    # the non-empty rows (what accumulate mode visits) hold every edge once
    visited = np.concatenate([busy, longs])
    assert lens[visited].sum() == plan.nnz and len(np.unique(visited)) == len(visited)


def test_k1_plain_rounds_bf16_weights():
    """With bf16 x the plain version multiplies by the bf16-rounded weight
    (exact products, summed in f32); with f32 x by the f32 weight."""
    rng = np.random.RandomState(8)
    rows, cols = rng.randint(0, 20, 150), rng.randint(0, 30, 150)
    plan = CSRPlan.build(rows, cols, np.arange(150), 20)
    x = torch.from_numpy(rng.randn(30, 8).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.rand(150) * 3).astype(np.float32))
    wr = w.to(torch.bfloat16).float().numpy().astype(np.float64)
    ref = _oracle(x.float().numpy(), wr, rows, cols, np.arange(150), 20)
    out = segment_spmm_csr(x, w, plan).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    assert np.abs(out - _oracle(x.float().numpy(), w.numpy(), rows, cols,
                                np.arange(150), 20)).max() > 1e-3


@pytest.mark.parametrize("windowed", [False, True])
def test_plain_versions_switch(monkeypatch, windowed):
    """spmm.plain_versions() routes gather_scatter to the plain versions
    only inside its block, and restores the kernels after an exception."""
    calls = []
    for name in ("segment_spmm_csr", "segment_spmm_csr_plain",
                 "windowed_spmm", "windowed_spmm_plain"):
        fn = getattr(spmm, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(spmm, name, spy)
    rng = np.random.RandomState(5)
    src = rng.randint(0, 300, 1500)
    dst = np.clip(src + rng.randint(-8, 9, 1500), 0, 299)
    g = Graph.from_edges(np.stack([src, dst]), rng.rand(1500), 300)
    if windowed:
        g = g.with_window_meta(Wb=128, nwin=1)
        assert g.winplan is not None
    g = g.with_sorted_meta("cpu")
    x = torch.from_numpy(rng.randn(300, 2, 4).astype(np.float32))
    kern = "windowed_spmm" if windowed else "segment_spmm_csr"
    ref = spmm.spmm_mean(x, g, g.edge_attr)
    with spmm.plain_versions():
        out = spmm.spmm_mean(x, g, g.edge_attr)
    with pytest.raises(RuntimeError):
        with spmm.plain_versions():
            raise RuntimeError
    spmm.spmm_mean(x, g, g.edge_attr)
    assert calls == [kern, kern + "_plain", kern]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


def test_csr_plan_rejects_bad_inputs():
    with pytest.raises(ValueError):
        CSRPlan.build(np.array([0, 5]), np.array([0, 1]), np.array([0, 1]), 5)
    plan = CSRPlan.build(np.array([0, 1]), np.array([0, 7]), np.array([0, 1]), 2)
    with pytest.raises(ValueError):
        segment_spmm_csr(torch.zeros(4, 8), torch.ones(2), plan)  # col 7 >= 4
    with pytest.raises(TypeError):
        segment_spmm_csr(torch.zeros(8, 8, dtype=torch.float16), torch.ones(2), plan)
