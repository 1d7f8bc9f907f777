"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (with its reason) where torch sees no CUDA
device, as on a CPU-only machine.  On a GPU host:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q --noconftest

(--noconftest: the repo's conftest configures JAX, which a GPU host for
the port need not have.)  Cases: random graphs with empty rows and
duplicate (dst, src) pairs, padded/masked edges, permuted window plans,
feature widths on and off the vector path, accumulate mode, bf16 and f32;
the backward forms: K2 on the transpose side (banded, permuted,
residual-heavy) with K1 over tres and res_csc, K1 over a graph's csc, and
K1 as the gather_rows backward.  K3 (segment max): widths on and off the
vector path, rows that do not start on a 16-byte boundary, rows with more
than 256 entries, empty rows and an empty plan, exact ties, and
edge_segment_max's gradient with K3 against the same with the plain
version.  K4 (sorted segment-sum): B = 1 and 3, the 2-D form, widths on
and off the vector path (C = 64, 40, 130, 2048), empty segments, a hub
segment, segment_sum_by through a non-identity perm with dropped rows, and
an empty plan; held to 1e-5 x max(1, max|plain|) in both dtypes (both sum
the same exact values in f32, in different orders).

Tolerance: max|kernel - plain| <= tol * max(1, max|plain|), tol = 1e-4 for
f32 (sum order) and 2e-3 for bf16 (an entry's bf16 rounding can differ when
its f32 sum is taken in another order).  K3 is held to equality: a max
selects one of its inputs.
"""
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu_torch.ops.kernels import segment_max as k3
from multilevel_gnn_tpu_torch.ops.kernels import segment_sum as k1
from multilevel_gnn_tpu_torch.ops.kernels import windowed as k2

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _close(out, ref, dtype):
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    lim = TOL[dtype] * max(1.0, float(ref.abs().max()) if ref.numel() else 0.0)
    assert err <= lim, (err, lim)


def _graph(seed, n, e, hub=False):
    rng = np.random.RandomState(seed)
    src = rng.randint(0, n, e)
    dst = np.clip(src + rng.randint(-60, 61, e), 0, n - 20)  # last rows empty
    if hub:
        k = e // 10
        src[:k] = rng.randint(0, 5, k)  # hub sources
        dst[:k] = rng.randint(0, n - 20, k)
        dst[k : 2 * k] = rng.randint(0, 2, k)  # rows with > 256 in-edges
    dup = rng.randint(0, e, e // 20)
    src = np.concatenate([src, src[dup]])  # repeated (dst, src) pairs
    dst = np.concatenate([dst, dst[dup]])
    return src.astype(np.int64), dst.astype(np.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [8, 20, 64, 2048, 2056])
def test_k1_matches_plain(dev, dtype, F):
    n = 900
    s, d = _graph(1, n, 7000, hub=True)
    mask = np.random.RandomState(2).rand(len(s)) > 0.1
    eid = np.flatnonzero(mask)
    plan = k1.CSRPlan.build(d[eid], s[eid], eid, n).to(dev)
    g = torch.Generator(device=dev).manual_seed(F)
    x = torch.randn(n, F, generator=g, device=dev).to(dtype)
    w = torch.randn(len(s), generator=g, device=dev)
    _close(k1.segment_spmm_csr(x, w, plan), k1.segment_spmm_csr_plain(x, w, plan), dtype)
    base = torch.randn(n, F, generator=g, device=dev)
    out = k1.segment_spmm_csr(x, w, plan, out=base.clone())
    _close(out, k1.segment_spmm_csr_plain(x, w, plan, out=base.clone()), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,Wb,nwin,hub", [
    (128, 128, 2, False), (20, 256, 1, True), (136, 128, 1, True),
    (2048, 512, 2, True),
])
def test_k2_matches_plain(dev, dtype, F, Wb, nwin, hub):
    n = 1000
    s, d = _graph(3, n, 8000, hub=hub)
    plan = k2.build_plan(s, d, n, Wb=Wb, nwin=nwin).to(dev)
    g = torch.Generator(device=dev).manual_seed(F + Wb)
    x = torch.randn(n, F, generator=g, device=dev).to(dtype)
    w = torch.randn(len(s), generator=g, device=dev)
    _close(k2.windowed_tile_spmm(x, w, plan), k2.windowed_tile_spmm_plain(x, w, plan), dtype)
    full = k2.windowed_spmm(x, w, plan)
    _close(full, k2.windowed_spmm_plain(x, w, plan), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_permuted_plan_matches_plain(dev, dtype):
    rng = np.random.RandomState(4)
    n, e = 600, 4000
    comm = rng.randint(0, 2, n)
    order = np.argsort(rng.rand(n))
    members = [order[comm[order] == c] for c in (0, 1)]
    cs = rng.randint(0, 2, e)
    s = np.array([members[c][rng.randint(len(members[c]))] for c in cs])
    d = np.array([members[c][rng.randint(len(members[c]))] for c in cs])
    mask = rng.rand(e) > 0.1
    perm, _, _ = k2.choose_node_perm(s[mask], d[mask], n, Wb=128, nwin=2)
    assert perm is not None
    plan = k2.build_plan(s, d, n, mask=mask, perm=perm, Wb=128, nwin=2).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n, 96, generator=g, device=dev).to(dtype)
    w = torch.randn(e, generator=g, device=dev)
    _close(k2.windowed_spmm(x, w, plan), k2.windowed_spmm_plain(x, w, plan), dtype)


def _perm_graph(rng, n, e):
    comm = rng.randint(0, 2, n)
    order = np.argsort(rng.rand(n))
    members = [order[comm[order] == c] for c in (0, 1)]
    cs = rng.randint(0, 2, e)
    s = np.array([members[c][rng.randint(len(members[c]))] for c in cs])
    d = np.array([members[c][rng.randint(len(members[c]))] for c in cs])
    return s.astype(np.int64), d.astype(np.int64)


def _transpose_plan(case):
    rng = np.random.RandomState(7)
    if case == "banded":
        n = 1000
        s = rng.randint(0, n, 8000)
        d = np.clip(s + rng.randint(-100, 101, 8000), 0, n - 1)
        return n, k2.build_plan(s, d, n, Wb=128, nwin=2)
    if case == "residual_heavy":
        n = 1000
        s, d = _graph(8, n, 8000, hub=True)
        d[:400] = rng.randint(0, 3, 400)  # hub receivers: transposes leave windows
        return n, k2.build_plan(s, d, n, Wb=128, nwin=2)
    n = 600
    s, d = _perm_graph(rng, n, 4000)
    mask = rng.rand(len(s)) > 0.1
    perm, _, _ = k2.choose_node_perm(s[mask], d[mask], n, Wb=128, nwin=2)
    assert perm is not None
    return n, k2.build_plan(s, d, n, mask=mask, perm=perm, Wb=128, nwin=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["banded", "permuted", "residual_heavy"])
def test_k2_transpose_side_matches_plain(dev, dtype, case):
    n, plan = _transpose_plan(case)
    if case == "residual_heavy":
        assert plan.n_tres > 0 and plan.n_res > 0
    plan = plan.to(dev)
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(n, 264, generator=g, device=dev).to(dtype)
    w = torch.randn(plan.n_edges, generator=g, device=dev)
    _close(k2.windowed_tile_spmm(x, w, plan, transpose=True),
           k2.windowed_tile_spmm_plain(x, w, plan, transpose=True), dtype)
    _close(k2.windowed_spmm(x, w, plan, transpose=True),
           k2.windowed_spmm_plain(x, w, plan, transpose=True), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [64, 1024, 2048])
def test_k1_csc_and_gather_backward_match_plain(dev, dtype, F):
    from multilevel_gnn_tpu_torch.core.graph import Graph

    n = 900
    s, d = _graph(9, n, 7000, hub=True)
    graph = Graph.from_edges(np.stack([s, d]), None, n).with_sorted_meta(dev)
    g = torch.Generator(device=dev).manual_seed(F)
    x = torch.randn(n, F, generator=g, device=dev).to(dtype)
    w = torch.randn(graph.num_padded_edges, generator=g, device=dev)
    _close(k1.segment_spmm_csr(x, w, graph.csc),
           k1.segment_spmm_csr_plain(x, w, graph.csc), dtype)
    rng = np.random.RandomState(F)
    idx = rng.randint(0, n, 2500)
    idx[:300] = n - 1  # many rows resolved from -1 to the last slot
    plan = k1.CSRPlan.gather(idx, n).to(dev)
    gx = torch.randn(len(idx), F, generator=g, device=dev).to(dtype)
    ones = torch.ones(len(idx), device=dev)
    _close(k1.segment_spmm_csr(gx, ones, plan),
           k1.segment_spmm_csr_plain(gx, ones, plan), dtype)


def test_empty_plans(dev):
    n = 300
    plan = k2.build_plan(np.zeros(0, int), np.zeros(0, int), n).to(dev)
    x = torch.randn(n, 64, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(0, device=dev)
    assert torch.count_nonzero(k2.windowed_spmm(x, w, plan)) == 0
    csr = k1.CSRPlan.build(np.zeros(0), np.zeros(0), np.zeros(0), n).to(dev)
    assert torch.count_nonzero(k1.segment_spmm_csr(x, w, csr)) == 0


def _k3_plan(dev, n=900):
    s, d = _graph(5, n, 7000, hub=True)  # hub rows > 256 entries, empty rows
    mask = np.random.RandomState(6).rand(len(s)) > 0.1
    eid = np.flatnonzero(mask)
    return len(s), k1.CSRPlan.build(d[eid], s[eid], eid, n).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [8, 20, 64, 1024, 2048, 2056])
def test_k3_equals_plain(dev, dtype, F):
    E, plan = _k3_plan(dev)
    g = torch.Generator(device=dev).manual_seed(F)
    msg = torch.randn(E, F, generator=g, device=dev).to(dtype)
    out = k3.segment_max_csr(msg, plan)
    assert out.dtype == torch.float32
    assert torch.equal(out, k3.segment_max_csr_plain(msg, plan))
    empty = plan.rowptr[1:] == plan.rowptr[:-1]
    assert bool(empty.any()) and not bool(out[empty].any())
    # rows off the 16-byte boundary take the scalar path
    buf = torch.randn(E * F + 1, generator=g, device=dev).to(dtype)
    shifted = buf[1:].view(E, F)
    assert torch.equal(k3.segment_max_csr(shifted, plan),
                       k3.segment_max_csr_plain(shifted, plan))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_ties_and_gradient_equal_plain(dev, dtype):
    from multilevel_gnn_tpu_torch.ops import spmm

    E, plan = _k3_plan(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    msg0 = (torch.randint(-2, 3, (E, 2, 24), generator=g, device=dev) * 0.5).to(dtype)
    recv = torch.zeros(E, dtype=torch.long, device=dev)
    recv[plan.eid.long()] = plan.row.long()
    mask = torch.zeros(E, dtype=torch.bool, device=dev)
    mask[plan.eid.long()] = True
    cot = torch.randn(plan.n_rows, 2, 24, generator=g, device=dev)
    res = []
    for plain in (False, True):
        m = msg0.clone().requires_grad_(True)
        if plain:
            with spmm.plain_versions():
                out = spmm.edge_segment_max(m, recv, mask, plan)
        else:
            out = spmm.edge_segment_max(m, recv, mask, plan)
        out.backward(cot)
        res.append((out.detach(), m.grad))
    assert torch.equal(res[0][0], res[1][0]) and torch.equal(res[0][1], res[1][1])
    assert int(torch.count_nonzero(res[0][1])) > int(torch.count_nonzero(res[0][0]))


def test_k3_empty_plan(dev):
    n = 300
    plan = k1.CSRPlan.build(np.zeros(0), np.zeros(0), np.zeros(0), n).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        msg = torch.randn(0, 64, device=dev, dtype=dtype)
        out = k3.segment_max_csr(msg, plan)
        assert out.shape == (n, 64) and not bool(out.any())


def _k4_case(seed, E, N, sort=True, hub=False, drop=False):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, N - 10, E)  # the last segments stay empty
    if hub:
        ids[: E // 3] = 5
    if sort:
        ids = np.sort(ids)
    mask = rng.rand(E) > 0.2 if drop else None
    if drop:
        ids[rng.rand(E) < 0.1] = -1
    return k1.SortedPlan.build(ids, N, mask=mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C", [(1, 64), (3, 64), (3, 40), (2, 130), (1, 2048)])
def test_k4_sorted_matches_plain(dev, dtype, B, C):
    plan = _k4_case(B * 7 + C, 3000, 700, hub=C == 40).to(dev)
    g = torch.Generator(device=dev).manual_seed(C)
    x = torch.randn(B, plan.n_ids, C, generator=g, device=dev).to(dtype)
    out = k1.sorted_segment_sum(x, plan)
    ref = k1.sorted_segment_sum_plain(x, plan)
    TOL4 = 1e-5
    for o, r in ((out, ref), (k1.sorted_segment_sum(x[0], plan),
                              k1.sorted_segment_sum_plain(x[0], plan))):
        torch.cuda.synchronize()
        err = float((o - r).abs().max())
        assert err <= TOL4 * max(1.0, float(r.abs().max())), err
    assert float(out[:, -10:].abs().max()) == 0.0  # empty segments


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C", [(1, 64), (3, 24)])
def test_k4_segment_sum_by_perm_matches_plain(dev, dtype, B, C):
    plan = _k4_case(B + C, 2500, 400, sort=False, drop=True).to(dev)
    assert plan.perm is not None and plan.n_kept < plan.n_ids
    g = torch.Generator(device=dev).manual_seed(B)
    x = torch.randn(B, plan.n_ids, C, generator=g, device=dev).to(dtype)
    before = k1.SORTED_KERNEL.launches
    out = k1.segment_sum_by(x, plan)
    assert k1.SORTED_KERNEL.launches == before + 1
    ref = k1.sorted_segment_sum_plain(x, plan, permuted=True)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))


def test_k4_empty_plan(dev):
    plan = k1.SortedPlan.build(np.full(10, -1), 6).to(dev)
    x = torch.randn(2, 10, 16, device=dev)
    out = k1.sorted_segment_sum(x, plan)
    assert out.shape == (2, 6, 16) and float(out.abs().max()) == 0.0
