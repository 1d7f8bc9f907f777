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


def _check_classes(plan, accumulate=False):
    """The plan's three row classes cover each row once: items (rows with
    1..LONG_ROW entries first, n_busy of them, then the empty rows),
    long_rows (LONG_ROW + 1 .. SPLIT_ROW entries) and split_rows (more),
    each split row's chunks listed in chunk_row at chunk_ptr[s] ..
    chunk_ptr[s + 1], ceil(len / SPLIT_ROW) of them, each of at most
    SPLIT_ROW consecutive entries; -1 entries (a device-built plan's
    padding, which no chunk names) skipped.  Returns the entry ranges visited, in launch order."""
    lens = np.diff(plan.rowptr.numpy())
    rp = plan.rowptr.numpy()
    items = plan.items.numpy()
    busy, empty = items[: plan.n_busy], items[plan.n_busy:]
    busy, empty = busy[busy >= 0], empty[empty >= 0]
    longs = plan.long_rows.numpy()
    longs = longs[longs >= 0]
    split = plan.split_rows.numpy()
    cp, cr = plan.chunk_ptr.numpy(), plan.chunk_row.numpy()
    assert len(cp) == len(split) + 1 and cp[0] == 0 and np.all(np.diff(cp) >= 0)
    assert np.all((lens[busy] <= k1.LONG_ROW) | (lens[busy] == 0))
    assert np.all(lens[empty] == 0)
    assert np.all((lens[longs] > k1.LONG_ROW) & (lens[longs] <= k1.SPLIT_ROW))
    ranges = []
    for s, r in enumerate(split):
        n = cp[s + 1] - cp[s]
        if r < 0:  # padding: no chunk names it
            assert not np.any(cr == s)
            continue
        L = lens[r]
        assert L > k1.SPLIT_ROW and n == -(-L // k1.SPLIT_ROW)
        np.testing.assert_array_equal(cr[cp[s]:cp[s + 1]], s)
        bounds = rp[r] + L * np.arange(n + 1) // n
        assert np.all(np.diff(bounds) <= k1.SPLIT_ROW) and bounds[-1] == rp[r + 1]
        ranges += list(zip(bounds[:-1], bounds[1:]))
    assert (cr >= 0).sum() == len(ranges)
    rows = np.concatenate([busy, empty, longs, split[split >= 0]])
    np.testing.assert_array_equal(np.sort(rows), np.arange(plan.n_rows))
    ranges += [(rp[r], rp[r + 1]) for r in np.concatenate([busy, longs])]
    # every entry once, each range in CSR order within its row
    covered = np.zeros(plan.nnz, int)
    for b, e in ranges:
        covered[b:e] += 1
    assert np.all(covered == 1)
    return busy, longs, split[split >= 0]


@pytest.mark.parametrize("long_rows", [0, 3])
def test_csr_row_lists_cover_rows(long_rows):
    """items lists the rows with 1..LONG_ROW entries first (n_busy of them),
    then the empty rows; long_rows the longer ones up to SPLIT_ROW,
    split_rows (cut into chunks) the rest; each row once, each entry in
    one warp item, block or chunk."""
    rng = np.random.RandomState(4 + long_rows)
    n_rows = 200
    rows = rng.randint(0, n_rows - 30, 900)  # the last 30 rows stay empty
    hubs = np.repeat(rng.choice(n_rows - 30, long_rows, replace=False),
                     k1.LONG_ROW + 1 + rng.randint(0, 500, long_rows))
    splits = np.repeat(rng.choice(n_rows - 30, long_rows, replace=False),
                       k1.SPLIT_ROW + 1 + rng.randint(0, 2000, long_rows))
    rows = np.concatenate([rows, hubs, splits])
    plan = CSRPlan.build(rows, rng.randint(0, 50, len(rows)), np.arange(len(rows)), n_rows)
    lens = np.diff(plan.rowptr.numpy())
    busy, longs, split = _check_classes(plan)
    assert len(busy) == plan.n_busy
    assert len(longs) + len(split) == len(np.unique(np.concatenate([hubs, splits])))
    assert np.all(lens[split] > k1.SPLIT_ROW) and len(split) >= min(long_rows, 1)
    # the non-empty rows (what accumulate mode visits) hold every edge once
    visited = np.concatenate([busy, longs, split])
    assert lens[visited].sum() == plan.nnz and len(np.unique(visited)) == len(visited)


def _hub_entries(seed, n_rows=400, hubs=(700, 1500, 90, 300), k=9):
    """Sorted rows like the kNN graph's sender-sorted gather plan: k entries
    for most rows, a few empty rows, and hub rows of the given lengths."""
    rng = np.random.RandomState(seed)
    lens = np.full(n_rows, k)
    lens[rng.choice(n_rows, 20, replace=False)] = 0
    lens[rng.choice(n_rows, 40, replace=False)] = rng.randint(1, 60, 40)
    lens[rng.choice(n_rows, len(hubs), replace=False)] = hubs
    return np.repeat(np.arange(n_rows), lens), n_rows


def _lookup_entries(seed, n_rows=60, hub=4700):
    """Sorted rows like DeeperGCN's edge-id lookup: one row of ``hub``
    entries, the rest short or empty."""
    rng = np.random.RandomState(seed)
    ids = np.concatenate([np.zeros(hub, np.int64), rng.randint(1, n_rows - 10, 300)])
    return np.sort(ids), n_rows


@pytest.mark.parametrize("entries", [_hub_entries, _lookup_entries], ids=["hubs", "lookup"])
def test_on_device_plan_lists_match_build(entries):
    """CSRPlan.on_device on CPU tensors lists the classes and chunks of
    CSRPlan.build over the same sorted entries, padded with -1 (its items
    in row order, build's the busy rows first)."""
    rows, n_rows = entries(3)
    E = len(rows)
    cols = np.random.RandomState(4).randint(0, 80, E)
    host = CSRPlan.build(rows, cols, np.arange(E), n_rows)
    dev = CSRPlan.on_device(torch.from_numpy(rows), torch.from_numpy(cols),
                            torch.arange(E), n_rows, 79)
    assert len(host.split_rows) > 0
    for attr in ("rowptr", "col", "eid", "row"):
        assert torch.equal(getattr(dev, attr), getattr(host, attr)), attr
    items = dev.items[dev.items >= 0]
    assert torch.equal(items, torch.sort(host.items).values)
    for attr in ("long_rows", "split_rows", "chunk_row"):
        got = getattr(dev, attr)
        assert torch.equal(got[got >= 0], getattr(host, attr)), attr
        assert torch.all(got[(got >= 0).sum():] == -1), attr
    S = len(host.split_rows)
    assert torch.equal(dev.chunk_ptr[:S + 1], host.chunk_ptr)
    assert torch.all(dev.chunk_ptr[S:] == host.chunk_ptr[-1])
    assert dev.split_rows[-1] == -1  # the last split slot is always padding
    _check_classes(dev)
    _check_classes(host)


# ---- K1's summation order on the card, emulated on the host

def _lanes(F, dtype):
    """Lanes of a warp that read one entry (segment_spmm_csr.cu's launch):
    a row of the vector path under 512 bytes takes the power of two at or
    above its 16-byte vectors, any other row the whole warp."""
    size = 2 if dtype == torch.bfloat16 else 4
    if F % 8 or F * size >= 512:
        return 32
    G = 1
    while G * 16 < F * size:
        G *= 2
    return G


def _seq(vals, F):
    """f32 sum of vals in their order, from 0."""
    t = np.zeros(F, np.float32)
    for v in vals:
        t = t + v
    return t


def _warp_sum(p, groups):
    """One warp over the products p (CSR order): group g sums the entries
    g, g + groups, ... in order, then a butterfly adds the groups."""
    sums = [_seq(p[g::groups], p.shape[1]) for g in range(groups)]
    while len(sums) > 1:
        sums = [sums[i] + sums[i + 1] for i in range(0, len(sums), 2)]
    return sums[0]


def _block_sum(p, groups):
    """A block over p: warp w sums entries len * w // 8 .. len * (w + 1) //
    8, then the eight sums in warp order."""
    n = len(p)
    return _seq([_warp_sum(p[n * w // 8:n * (w + 1) // 8], groups) for w in range(8)],
                p.shape[1])


def _kernel_order(x, w, plan, out=None):
    """segment_spmm_csr with K1's order of additions on the card, in f32 on
    the host (each product rounded before its addition, where the card
    fuses it): warp items, long-row blocks, and each split row's chunks
    summed as blocks, then their partial rows added by eight runs of
    chunks in chunk order and the runs in order."""
    F = x.shape[1]
    xf = x.float().numpy()
    we = w.index_select(0, plan.eid.long())
    if x.dtype == torch.bfloat16:
        we = we.to(torch.bfloat16)
    we = we.float().numpy()
    col, rp = plan.col.numpy(), plan.rowptr.numpy()
    groups = 32 // _lanes(F, x.dtype)

    def prod(b, e):
        return xf[col[b:e]] * we[b:e, None]

    res = np.zeros((plan.n_rows, F), np.float32)
    items = plan.items.numpy()[: plan.n_busy] if out is not None else plan.items.numpy()
    for r in items[items >= 0]:
        res[r] = _warp_sum(prod(rp[r], rp[r + 1]), groups)
    for r in plan.long_rows.numpy():
        if r >= 0:
            res[r] = _block_sum(prod(rp[r], rp[r + 1]), groups)
    cp = plan.chunk_ptr.numpy()
    for s, r in enumerate(plan.split_rows.numpy()):
        if r < 0:
            continue
        n, L = cp[s + 1] - cp[s], rp[r + 1] - rp[r]
        parts = [_block_sum(prod(rp[r] + L * k // n, rp[r] + L * (k + 1) // n), groups)
                 for k in range(n)]
        res[r] = _seq([_seq(parts[n * w // 8:n * (w + 1) // 8], F) for w in range(8)], F)
    return torch.from_numpy(res) if out is None else out + torch.from_numpy(res)


def _jax_flat(x, w, plan):
    """JAX's flat_segment_sum (interpret mode) over the plan's entries: the
    gathered rows, weighted in the kernel (bf16) or before it (f32)."""
    from multilevel_gnn_tpu.ops.pallas.segment_sum import (
        SortedSegments, flat_segment_sum, flatten_rows)

    rows = plan.row.numpy()
    seg = SortedSegments.build(rows, plan.n_rows, te=256)
    msg = jnp.asarray(x.float().numpy()[plan.col.numpy()]).astype(
        jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)
    we = w.index_select(0, plan.eid.long()).numpy()
    wf = jnp.take(jnp.concatenate([jnp.asarray(we), jnp.zeros(1)]), seg.perm_pad)
    return np.asarray(flat_segment_sum(flatten_rows(msg, seg), seg, interpret=True, w=wf))


def _order_case(entries, seed, F, dtype):
    rows, n_rows = entries(seed)
    E = len(rows)
    rng = np.random.RandomState(seed + 1)
    cols = rng.randint(0, 90, E)
    plan = CSRPlan.on_device(torch.from_numpy(rows), torch.from_numpy(cols),
                             torch.arange(E), n_rows, 89)
    x = torch.from_numpy(rng.randn(90, F).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.rand(E) + 0.5).astype(np.float32))
    return plan, x, w


def _rel_close(out, ref, tol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert np.abs(out - ref).max() <= tol * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("F", [64, 128, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("entries", [_hub_entries, _lookup_entries], ids=["hubs", "lookup"])
def test_k1_kernel_order_matches_plain(entries, dtype, F):
    """The card's order of additions (chunks, blocks, lane groups) gives the
    plain version's sums within 1e-5 relative, on a plan with one row of
    more than SPLIT_ROW entries and one with hub rows like the kNN plan's,
    built on the device; overwrite and accumulate mode."""
    plan, x, w = _order_case(entries, 5, F, dtype)
    assert plan.split_rows[0] >= 0
    _rel_close(_kernel_order(x, w, plan), segment_spmm_csr_plain(x, w, plan), 1e-5)
    base = torch.from_numpy(np.random.RandomState(6).randn(plan.n_rows, F).astype(np.float32))
    _rel_close(_kernel_order(x, w, plan, base.clone()),
               segment_spmm_csr_plain(x, w, plan, base.clone()), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("entries", [_hub_entries, _lookup_entries], ids=["hubs", "lookup"])
def test_k1_kernel_order_matches_jax_flat(entries, dtype):
    """The same emulated order against JAX's flat_segment_sum in interpret
    mode (bf16: both round each weight to bf16 and sum exact products), at
    F 64, the kNN plan's width."""
    plan, x, w = _order_case(entries, 7, 64, dtype)
    _rel_close(_kernel_order(x, w, plan), _jax_flat(x, w, plan), 1e-5)


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
