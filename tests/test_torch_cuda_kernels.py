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
the same exact values in f32, in different orders).  The K1 / K2 layouts:
a star graph with a 5,000-edge hub (K1's long-row blocks on csr and csc,
K2's hub rows on both sides), accumulate mode over 3 rows of 10,000 edges
(the other rows untouched), K2 on a permuted plan at F = 8, 20, 64, 2048,
2056 on both sides, and a dense sub-block split into blocks at the entry
cap.  K1's three row classes: DeeperGCN's edge-id lookup (one row of
120,001 entries at (E, 128) f32) alone and five stacked (equal to the own
launches), a plan built on the card with kNN-like hub rows at F 64 (equal
bit for bit to the host-built plan), and warp, long and split rows at F
8, 20, 64, 128 and 256 in both modes, each form's two calls equal bit for
bit.  Integrated gradients with K1 / K2 against the same with the plain
versions (windowed and composed, bf16 and f32, same tolerances), and a
checkpoint written on the card loaded on the CPU and on the card.  The
mgtpu custom ops: torch.library.opcheck on CUDA tensors and each op's CUDA
kernel against its plain version (test_torch_ops.py's cases); a small bf16
windowed fold exported on the card and loaded in a fresh process (equal
to the live eval within 1e-6 x max(1, max|ref|), the same K1 / K2
launches); warm_experiment building every kernel and data library.  The stacked forms
of fold-parallel CV (three graphs of one node count, different topologies
and edge counts, stacked block-diagonally): K1 over csr, csc, src_gather
and dst_gather and K3 at F 64 and 2,048, K2 and the windowed SpMM on both
sides at F 20 and 2,048 (permuted and identity window plans), each equal
to the units' own launches bit for bit and within TOL of the plain
version; a stacked train step of three small windowed folds (bf16, f32;
1,200 node slots over two windows, so each fold has residual and tres
edges) launching K1 7 / K2 4, as often as one unit's own train step,
each unit's gradients within 35 x TOL of the largest of its own step's
(batched GEMMs and a grouped convolution in place of the unit's own).  P1
(the per-row gather probe): at tools/bench_dma_gather.py's shapes (N
15,408, E 165,888, te 256), with a short last chunk, with te 1,024 and
with chunks of 3 rows, bf16 and f32, against the plain version within 1e-4
x max(1, max|plain|) in both dtypes (the inputs are exact in f32), two
calls equal bit for bit; an empty src gives zeros.  P1 equal bit for bit
to ``dma_row_gather_ordered`` (its order of additions) at the tool's
shapes, E = 0, E < te, a short last chunk, fewer chunks than SMs, te = 1,
te = 1,024 and te not a multiple of a ring slot's rows, bf16 and f32.
PW (the pathway contraction's kernels) against their plain versions at
kirc's shapes (G 25,015, S 438, K 3, F 2,048), gbm's (K 2, F 1,024),
PathCNN's (F = B = 64), off the vector path (F 20) and with a slot of 1,000
rows (eight chunks), bf16 and f32: the forward and dP within TOL[f32], dx
equal, two calls equal bit for bit; pathway_contract on the card building
neither the one-hot nor its weighted copy, and the launches of a train
step (PW forward 1, backward 1, K1 7, K2 4) and of an eval batch (PW
forward 1, K1 2, K2 2).

Tolerance: max|kernel - plain| <= tol * max(1, max|plain|), tol = 1e-4 for
f32 (sum order) and 2e-3 for bf16 (an entry's bf16 rounding can differ when
its f32 sum is taken in another order).  K3 is held to equality: a max
selects one of its inputs.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from multilevel_gnn_tpu_torch.ops.kernels import dma_gather as p1
from multilevel_gnn_tpu_torch.ops.kernels import pathway as pw
from multilevel_gnn_tpu_torch.ops.kernels import segment_max as k3
from multilevel_gnn_tpu_torch.ops.kernels import segment_sum as k1
from multilevel_gnn_tpu_torch.ops.kernels import windowed as k2
from test_torch_ops import NAMES as OP_NAMES
from test_torch_ops import _case as op_case

GBM_YAML = str(Path(__file__).resolve().parents[1] / "configs" / "gbm.yaml")

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


def _star(n=6000, hub_edges=5000, seed=12):
    """Node 7 sends to and receives from 5,000 others; a ring links all."""
    rng = np.random.RandomState(seed)
    others = rng.choice(n, hub_edges, replace=False)
    s = np.concatenate([np.full(hub_edges, 7), others, np.arange(n)])
    d = np.concatenate([others, np.full(hub_edges, 7), (np.arange(n) + 1) % n])
    return n, s.astype(np.int64), d.astype(np.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [64, 2048])
def test_star_hub_matches_plain(dev, dtype, F):
    n, s, d = _star()
    eid = np.arange(len(s))
    g = torch.Generator(device=dev).manual_seed(F)
    x = torch.randn(n, F, generator=g, device=dev).to(dtype)
    w = torch.rand(len(s), generator=g, device=dev)
    for rows, cols in ((d, s), (s, d)):  # csr, csc
        plan = k1.CSRPlan.build(rows, cols, eid, n)
        assert plan.split_rows.tolist() == [7] and plan.long_rows.numel() == 0
        plan = plan.to(dev)
        _close(k1.segment_spmm_csr(x, w, plan), k1.segment_spmm_csr_plain(x, w, plan), dtype)
    plan = k2.build_plan(s, d, n, Wb=512, nwin=2).to(dev)
    assert plan.n_res > 0
    for transpose in (False, True):
        _close(k2.windowed_tile_spmm(x, w, plan, transpose),
               k2.windowed_tile_spmm_plain(x, w, plan, transpose), dtype)
        _close(k2.windowed_spmm(x, w, plan, transpose),
               k2.windowed_spmm_plain(x, w, plan, transpose), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_accumulate_over_few_long_rows(dev, dtype):
    n, F = 10000, 256
    rng = np.random.RandomState(13)
    rows = np.repeat([3, 1000, 9999], 10000)
    cols = rng.randint(0, n, len(rows))
    plan = k1.CSRPlan.build(rows, cols, np.arange(len(rows)), n)
    assert plan.n_busy == 0 and plan.split_rows.tolist() == [3, 1000, 9999]
    plan = plan.to(dev)
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(n, F, generator=g, device=dev).to(dtype)
    w = torch.randn(len(rows), generator=g, device=dev)
    base = torch.randn(n, F, generator=g, device=dev)
    out = k1.segment_spmm_csr(x, w, plan, out=base.clone())
    _close(out, k1.segment_spmm_csr_plain(x, w, plan, out=base.clone()), dtype)
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    keep[[3, 1000, 9999]] = False
    assert torch.equal(out[keep], base[keep])


def _twice(fn):
    """fn() twice, the two results equal bit for bit (K1's order of
    additions does not depend on which block finishes last)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    return a


def _lookup_plan(hub=120_001, n_rows=5_548):
    """DeeperGCN's edge-id lookup backward: every gene edge into table row 0."""
    return k1.CSRPlan.gather(np.zeros(hub, np.int64), n_rows)


def test_k1_lookup_row(dev):
    """One row of 120,001 entries at (E, 128) f32, cut into chunks over the
    card; the other table rows empty and set to zero."""
    plan = _lookup_plan()
    assert plan.split_rows.tolist() == [0]
    assert plan.chunk_row.numel() == -(-120_001 // k1.SPLIT_ROW)
    plan = plan.to(dev)
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(plan.nnz, 128, generator=g, device=dev)
    w = torch.ones(plan.nnz, device=dev)
    out = _twice(lambda: k1.segment_spmm_csr(x, w, plan))
    _close(out, k1.segment_spmm_csr_plain(x, w, plan), torch.float32)
    assert float(out[1:].abs().max()) == 0.0


def test_k1_stacked_lookup_rows(dev):
    """Five such rows stacked (CSRPlan.stack): equal bit for bit to the five
    units' own launches, and within TOL of the plain version."""
    U, E, V = 5, 120_001, 5_548
    units = [_lookup_plan(E, V) for _ in range(U)]
    plan = k1.CSRPlan.stack(units, E, E).to(dev)
    assert plan.split_rows.tolist() == [u * V for u in range(U)]
    g = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn(U * E, 128, generator=g, device=dev)
    w = torch.ones(U * E, device=dev)
    out = _twice(lambda: k1.segment_spmm_csr(x, w, plan))
    own = torch.cat([k1.segment_spmm_csr(x[u * E:(u + 1) * E], w[:E], p.to(dev))
                     for u, p in enumerate(units)])
    assert torch.equal(out, own)
    _close(out, k1.segment_spmm_csr_plain(x, w, plan), torch.float32)


def _hub_rows(seed, n=4000, hubs=(3000, 1500, 700, 200, 90), k=9):
    """Sorted rows like the kNN graph's sender-sorted plan: k entries a row,
    some empty rows and hub rows of the given lengths."""
    rng = np.random.RandomState(seed)
    lens = np.full(n, k)
    lens[rng.choice(n, 50, replace=False)] = 0
    lens[rng.choice(n, len(hubs), replace=False)] = hubs
    return np.repeat(np.arange(n), lens), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_device_hub_plan(dev, dtype):
    """A plan built on the card (no host sync) at F 64: the same sums, bit
    for bit, as the host-built plan of the same entries, within TOL of the
    plain version, in both modes."""
    rows, n = _hub_rows(23)
    E = len(rows)
    cols = np.random.RandomState(24).randint(0, n, E)
    r, c = torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dplan = k1.CSRPlan.on_device(r, c, torch.arange(E, device=dev), n, n - 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    hplan = k1.CSRPlan.build(rows, cols, np.arange(E), n).to(dev)
    assert int((dplan.split_rows >= 0).sum()) == hplan.split_rows.numel() == 3
    g = torch.Generator(device=dev).manual_seed(25)
    x = torch.randn(n, 64, generator=g, device=dev).to(dtype)
    w = torch.rand(E, generator=g, device=dev)
    out = _twice(lambda: k1.segment_spmm_csr(x, w, dplan))
    assert torch.equal(out, k1.segment_spmm_csr(x, w, hplan))
    _close(out, k1.segment_spmm_csr_plain(x, w, dplan), dtype)
    base = torch.randn(n, 64, generator=g, device=dev)
    acc = _twice(lambda: k1.segment_spmm_csr(x, w, dplan, out=base.clone()))
    _close(acc, k1.segment_spmm_csr_plain(x, w, dplan, out=base.clone()), dtype)
    empty = dplan.rowptr[1:] == dplan.rowptr[:-1]
    assert torch.equal(acc[empty], base[empty]) and float(out[empty].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [8, 20, 64, 128, 256])
def test_k1_narrow_and_split_rows(dev, dtype, F):
    """Warp rows, long rows and split rows (of 513 .. 5,000 entries) at
    narrow widths (lane groups under 512 bytes a row) and the widths of
    one and two vectors a lane: overwrite mode (empty rows zero) and
    accumulate mode (rows without entries left equal to the base), each
    within TOL of the plain version and equal bit for bit over two calls."""
    n = 3000
    rng = np.random.RandomState(F)
    rows = np.concatenate([rng.randint(0, n - 100, 20_000),
                           np.repeat([5, 17, 29, 41, 53], [5000, 1300, 513, 300, 65])])
    plan = k1.CSRPlan.build(rows, rng.randint(0, n, len(rows)), np.arange(len(rows)), n)
    assert plan.split_rows.tolist() == [5, 17, 29] and plan.long_rows.numel() >= 2
    plan = plan.to(dev)
    g = torch.Generator(device=dev).manual_seed(F)
    x = torch.randn(n, F, generator=g, device=dev).to(dtype)
    w = torch.randn(len(rows), generator=g, device=dev)
    out = _twice(lambda: k1.segment_spmm_csr(x, w, plan))
    _close(out, k1.segment_spmm_csr_plain(x, w, plan), dtype)
    assert float(out[-100:].abs().max()) == 0.0
    base = torch.randn(n, F, generator=g, device=dev)
    acc = _twice(lambda: k1.segment_spmm_csr(x, w, plan, out=base.clone()))
    _close(acc, k1.segment_spmm_csr_plain(x, w, plan, out=base.clone()), dtype)
    assert torch.equal(acc[-100:], base[-100:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [8, 20, 64, 2048, 2056])
def test_k2_permuted_widths_both_sides(dev, dtype, F):
    n, plan = _transpose_plan("permuted")
    plan = plan.to(dev)
    g = torch.Generator(device=dev).manual_seed(F + 1)
    x = torch.randn(n, F, generator=g, device=dev).to(dtype)
    w = torch.randn(plan.n_edges, generator=g, device=dev)
    for transpose in (False, True):
        _close(k2.windowed_tile_spmm(x, w, plan, transpose),
               k2.windowed_tile_spmm_plain(x, w, plan, transpose), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_dense_sub_block_split(dev, dtype):
    """Every pair of a 128 x 128 block: 16,384 entries in one sub-block,
    split into blocks at the entry cap."""
    s0, d0 = np.meshgrid(np.arange(128), np.arange(128))
    n = 600
    plan = k2.build_plan(s0.ravel(), d0.ravel(), n, Wb=128, nwin=1)
    assert plan.fwd.n_blocks >= 16
    plan = plan.to(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(n, 136, generator=g, device=dev).to(dtype)
    w = torch.randn(plan.n_edges, generator=g, device=dev)
    for transpose in (False, True):
        _close(k2.windowed_tile_spmm(x, w, plan, transpose),
               k2.windowed_tile_spmm_plain(x, w, plan, transpose), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("windowed", [True, False], ids=["windowed", "composed"])
def test_integrated_gradients_kernels_match_plain(dev, dtype, windowed):
    """integrated_gradients with K1 / K2 (forward and the input gradient's
    backward) against the same with the plain versions, on a small cohort
    fold; held to TOL x max(1, max|plain|)."""
    from multilevel_gnn_tpu_torch.data.synthetic import make_gbm_scale_setup
    from multilevel_gnn_tpu_torch.ops import spmm
    from multilevel_gnn_tpu_torch.ops.kernels import build
    from multilevel_gnn_tpu_torch.train.explain import integrated_gradients

    bf16 = dtype == torch.bfloat16
    _, model, graph, ctx, batch = make_gbm_scale_setup(
        node_num=300, n_pathways=12, batch=8, gene_rows=900, topology="cohort",
        windowed=windowed, device=dev, compute_dtype="bfloat16" if bf16 else None,
        spmm_bf16=bf16)
    assert (graph.winplan is not None) == windowed
    for k in build.REGISTRY.values():
        k.launches = 0
    ig = integrated_gradients(model, batch, ctx, steps=4)
    assert k1.KERNEL.launches > 0 and (k2.KERNEL.launches > 0) == windowed
    with spmm.plain_versions():
        ref = integrated_gradients(model, batch, ctx, steps=4)
    assert bool(torch.isfinite(ig).all()) and float(ref.abs().max()) > 0
    _close(ig, ref, dtype)


@pytest.mark.parametrize("name", ["adam", "radam"])
def test_checkpoint_moves_between_devices(dev, tmp_path, name):
    """A checkpoint written on the card loads on the CPU and on the card:
    model and optimizer state equal to what was saved, and one more step
    from either equal to the same step on the saved optimizer (within f32
    rounding on the CPU); the dropout generator's state goes on."""
    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.train import checkpoint as C
    from multilevel_gnn_tpu_torch.train.step import make_optimizer

    def setup(device):
        torch.manual_seed(0)
        m = torch.nn.Linear(5, 3).to(device)
        return m, make_optimizer(m, Config(lr=1e-2), 2, name=name)

    def step(m, opt, x):
        m(x.to(m.weight.device)).sum().backward()
        opt.step()
        opt.zero_grad()

    m, opt = setup(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    xs = torch.randn(4, 4, 5, generator=torch.Generator().manual_seed(1))
    for x in xs[:3]:
        step(m, opt, x)
    C.save_checkpoint(str(tmp_path), m, opt, gen, step=1)
    step(m, opt, xs[3])
    for device in ("cpu", dev):
        # a fresh load each time: the optimizer takes the loaded moments
        # as its own where they are already on its device, and steps them
        tree, _ = C.load_checkpoint(str(tmp_path), 1)
        m2, opt2 = setup(device)
        m2.load_state_dict(tree["model"])
        opt2.load_state_dict(tree["optimizer"])
        assert opt2.count == 3
        for k, v in tree["model"].items():
            torch.testing.assert_close(m2.state_dict()[k].cpu(), v, rtol=0, atol=0)
        step(m2, opt2, xs[3])
        for (k, a), b in zip(m.named_parameters(), m2.parameters()):
            torch.testing.assert_close(b.detach().cpu(), a.detach().cpu(), rtol=1e-5,
                                       atol=1e-6, msg=lambda e, k=k: f"{device} {k}: {e}")
    g2 = torch.Generator(device=dev)
    g2.set_state(tree["generator"])
    torch.testing.assert_close(torch.rand(8, generator=g2, device=dev),
                               torch.rand(8, generator=gen, device=dev), rtol=0, atol=0)


def _on(dev, a):
    return a.to(dev) if isinstance(a, torch.Tensor) else a


@pytest.mark.parametrize("name", OP_NAMES)
def test_ops_opcheck_and_plain_on_cuda(dev, name):
    """torch.library.opcheck of each mgtpu op on CUDA tensors (schema, fake
    function, dispatch), and the CUDA kernel against the plain version on
    the same inputs (K3 and PW's dx equal)."""
    _, op, args, _ = op_case(name)
    args = tuple(_on(dev, a) for a in args)
    torch.library.opcheck(op, tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                    for a in args))
    _, op, cpu_args, ref = op_case(name)
    got = op(*args)
    if got is None:
        got = args[0]
    torch.cuda.synchronize()
    if name.startswith("k3"):
        assert torch.equal(got.cpu(), ref)
    elif name.startswith("pw_bwd"):  # dx equal, dP to f32's sum order
        assert torch.equal(got[0].cpu(), ref[0])
        _close(got[1].cpu(), ref[1], torch.float32)
    elif name.startswith("pw"):
        _close(got.cpu(), ref, torch.float32)
    else:
        dtype = cpu_args[0].dtype if not name.startswith("k1_acc") else cpu_args[1].dtype
        _close(got.cpu(), ref, dtype)


def test_export_round_trip_on_card(dev, tmp_path):
    """A small bf16 windowed fold exported on the card and loaded in a
    fresh process: probabilities equal to the live eval_step's within
    1e-6 x max(1, max|ref|), with K1 and K2 launching as in the live call."""
    import json
    import os
    import subprocess
    import sys

    from multilevel_gnn_tpu_torch.core.batch import Batch
    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.data.synthetic import make_synthetic_cohort
    from multilevel_gnn_tpu_torch.ops.kernels import build
    from multilevel_gnn_tpu_torch.train import export
    from multilevel_gnn_tpu_torch.train.step import eval_step

    cfg = Config.from_yaml(GBM_YAML, num_run=1, node_embedding_dim=8,
                           hidden_channels=16, final_channels=8, head_dim=16,
                           windowed_min_edges=1)
    cohort = make_synthetic_cohort(cfg, seed=3, n_patients=80, n_pathways=6)
    ex = export.export_fold(cfg, cohort, None, device=dev)
    st = ex["state"]
    assert st["ctx"].graph.winplan is not None
    out = str(tmp_path / "e")
    export.save_exported(out, ex)
    B = cfg.batch_size
    idx = np.arange(B) % len(cohort.patients)
    x, age = st["X"][idx], cohort.ages[idx]
    for k in build.REGISTRY.values():
        k.launches = 0
    live, _ = eval_step(st["model"], Batch(
        x=torch.as_tensor(x, device=dev), y=torch.zeros(B, 2, device=dev),
        age=torch.as_tensor(age, device=dev),
        sample_mask=torch.ones(B, dtype=torch.bool, device=dev)), st["ctx"])
    torch.cuda.synchronize()
    want = {k.name: k.launches for k in build.REGISTRY.values()}
    np.savez(str(tmp_path / "in.npz"), x=x, age=age)
    code = (
        "import json, sys, numpy as np, torch\n"
        "from multilevel_gnn_tpu_torch.artifact import load_exported\n"
        "from multilevel_gnn_tpu_torch.ops.kernels import build\n"
        "infer = load_exported(sys.argv[1]); z = np.load(sys.argv[2])\n"
        "infer(z['x'], z['age']); torch.cuda.synchronize()\n"
        "for k in build.REGISTRY.values(): k.launches = 0\n"
        "p = infer(z['x'], z['age']); torch.cuda.synchronize()\n"
        "print(json.dumps({'p': p.cpu().tolist(), "
        "'launches': {k.name: k.launches for k in build.REGISTRY.values()}}))\n")
    r = subprocess.run([sys.executable, "-c", code, out, str(tmp_path / "in.npz")],
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=str(Path(GBM_YAML).parents[1])))
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    ref = live.cpu().numpy()
    err = np.abs(np.asarray(got["p"]) - ref).max()
    assert err <= 1e-6 * max(1.0, np.abs(ref).max()), err
    assert got["launches"] == want and want["windowed_tile_spmm"] > 0


def test_warm_builds_kernels_and_libraries(dev):
    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.data.synthetic import make_synthetic_cohort
    from multilevel_gnn_tpu_torch.ops.kernels import build
    from multilevel_gnn_tpu_torch.train.warm import warm_experiment

    cfg = Config.from_yaml(GBM_YAML, num_run=1)
    cohort = make_synthetic_cohort(cfg, seed=0, n_patients=40, n_pathways=4)
    out = warm_experiment(cfg, cohort, dev)
    assert set(out["builds"]) == set(build.REGISTRY) | {"mi_knn", "csv_float", "fold0"}
    assert all(k._fn is not None for k in build.REGISTRY.values())


def _gene_graph(dev, n=1200, e=9000):
    """A gene-level-like Graph on the card: edges both ways, a hub pathway
    node with more than 256 in-edges, rows without in-edges."""
    from multilevel_gnn_tpu_torch.core.graph import Graph

    s, d = _graph(7, n, e // 2, hub=True)
    ei = np.concatenate([np.stack([s, d]), np.stack([d, s])], axis=1)
    hub = np.stack([np.arange(400), np.full(400, n - 1)])  # a pathway node
    ei = np.concatenate([ei, hub], axis=1)
    attr = np.random.RandomState(8).rand(ei.shape[1]).astype(np.float32)
    return Graph.from_edges(ei, attr, n).with_sorted_meta(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [4096, 8192])
def test_k3_at_genconv_widths_equals_plain(dev, dtype, F):
    """K3 at GENConv's F = B * H (32 x 128 and 64 x 128), where a row's
    edges are read in two or four 2,048-feature passes."""
    g = _gene_graph(dev)
    msg = torch.randn(g.num_padded_edges, F, generator=torch.Generator(device=dev)
                      .manual_seed(F), device=dev).to(dtype)
    out = k3.segment_max_csr(msg, g.csr)
    assert torch.equal(out, k3.segment_max_csr_plain(msg, g.csr))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_genconv_forms_at_4096_match_plain(dev, dtype):
    """K1 as edge_segment_sum's forward (unit weights over dst_gather) and
    as gather_src's backward (unit weights over src_gather) at F = 4096."""
    g = _gene_graph(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(g.num_padded_edges, 4096, generator=gen, device=dev).to(dtype)
    ones = torch.ones(g.num_padded_edges, device=dev)
    for plan in (g.dst_gather, g.src_gather):
        _close(k1.segment_spmm_csr(x, ones, plan), k1.segment_spmm_csr_plain(x, ones, plan),
               dtype)


@pytest.mark.parametrize("aggr", ["max", "softmax", "power"])
def test_genconv_kernels_match_plain(dev, aggr):
    """A bf16 GENConv's forward and gradients with K3 / K1 against the same
    with the plain versions (B = 4, H = 32)."""
    from multilevel_gnn_tpu_torch.nn.conv import GENConv
    from multilevel_gnn_tpu_torch.ops import spmm

    g = _gene_graph(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    x0 = torch.randn(g.n_nodes, 4, 32, generator=gen, device=dev)
    e0 = torch.randn(g.num_padded_edges, 32, generator=gen, device=dev)
    cot = torch.randn(g.n_nodes, 4, 32, generator=gen, device=dev)
    layer = GENConv(32, 32, aggr=aggr, learn_t=True, learn_p=True, encode_edge=True,
                    edge_feat_dim=32, norm_type="layer", dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(0)).to(dev)
    res = []
    for plain in (False, True):
        layer.zero_grad(set_to_none=True)
        x, e = x0.clone().requires_grad_(True), e0.clone().requires_grad_(True)
        if plain:
            with spmm.plain_versions():
                out = layer(x, g, e)
                out.backward(cot.to(out.dtype))
        else:
            out = layer(x, g, e)
            out.backward(cot.to(out.dtype))
        res.append([out.detach().float(), x.grad, e.grad]
                   + [p.grad for p in layer.parameters()])
    for a, b in zip(*res):
        err = float((a - b).abs().max())
        assert err <= 7e-2 * max(1.0, float(b.abs().max())), err


# ---- the stacked forms of fold-parallel CV (core/graph.py:stack_graphs):
# one launch over a block-diagonal plan equals the units' own launches bit
# for bit (each row is the same sum in the same order) and the plain
# version within TOL

def _stacked_units(dev, windowed, U=3, n=1000):
    from multilevel_gnn_tpu_torch.core.graph import Graph, stack_graphs

    graphs = []
    for u in range(U):
        rng = np.random.RandomState(40 + u)
        e = 6000 + 700 * u
        src = rng.randint(0, n, e)
        dst = np.clip(src + rng.randint(-60, 61, e), 0, n - 20)
        g = Graph.from_edges(np.stack([src, dst]), rng.rand(e).astype(np.float32), n)
        g = g.with_self_loops().pad_edges_to(e + n + 11 * u)
        if windowed:
            g = g.with_window_meta(Wb=256, nwin=2, min_frac=0.0, perm_group=3 if u else 1)
        graphs.append(g.with_sorted_meta(dev))
    return graphs, stack_graphs(graphs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [64, 2048])
def test_stacked_k1_k3_equal_per_unit_launches(dev, dtype, F):
    graphs, sg = _stacked_units(dev, False)
    U, N = len(graphs), graphs[0].n_nodes
    E = sg.fields["senders"].shape[1]
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(U * N, F, generator=g, device=dev).to(dtype)
    msg = torch.randn(U * E, F, generator=g, device=dev).to(dtype)
    w = torch.rand(U * E, generator=g, device=dev)
    for attr, cols, stride in (("csr", x, N), ("csc", x, N), ("src_gather", msg, E),
                               ("dst_gather", msg, E)):
        plan = getattr(sg.view, attr)
        out = k1.segment_spmm_csr(cols, w, plan)
        want = torch.cat([k1.segment_spmm_csr(cols[u * stride:(u + 1) * stride],
                                              w[u * E:(u + 1) * E].contiguous(),
                                              getattr(gr, attr))
                          for u, gr in enumerate(graphs)])
        assert torch.equal(out, want), attr
        _close(out, k1.segment_spmm_csr_plain(cols, w, plan), dtype)
    out = k3.segment_max_csr(msg, sg.view.csr)
    want = torch.cat([k3.segment_max_csr(msg[u * E:(u + 1) * E], gr.csr)
                      for u, gr in enumerate(graphs)])
    assert torch.equal(out, want)
    assert torch.equal(out, k3.segment_max_csr_plain(msg, sg.view.csr))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [20, 2048])
@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "transpose"])
def test_stacked_k2_equals_per_unit_launches(dev, dtype, F, transpose):
    graphs, sg = _stacked_units(dev, True)
    U, N = len(graphs), graphs[0].n_nodes
    E = sg.fields["senders"].shape[1]
    plan = sg.view.winplan
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(U * N, F, generator=g, device=dev).to(dtype)
    w = torch.rand(U * E, generator=g, device=dev)
    for fn in (k2.windowed_tile_spmm, k2.windowed_spmm):
        out = fn(x, w, plan, transpose)
        want = torch.cat([fn(x[u * N:(u + 1) * N],
                             w[u * E:u * E + gr.num_padded_edges].contiguous(),
                             gr.winplan, transpose) for u, gr in enumerate(graphs)])
        assert torch.equal(out, want), fn.__name__
    _close(k2.windowed_spmm(x, w, plan, transpose),
           k2.windowed_spmm_plain(x, w, plan, transpose), dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", None])
def test_stacked_step_matches_unit_steps(dev, dtype):
    """A stacked train step of three small windowed folds: each unit's
    gradients against its own step's (the same dropout masks) within
    TOL's limits of the largest, K1 / K2 launched as often as in one
    unit's own train step: K2 a layer forward and backward (4), K1 a
    layer over the residual (2) and over tres and res_csc (4), and once
    for the PCA gather's backward; PW in the unit's own step only (the
    stacked step's pathway contraction takes the dense form).  The folds have 1,200 node slots
    (node_num 400), two 1,024-row windows, so their plans have residual
    and tres edges; at 900 slots (one window) they had none, and K1 ran
    once.  TF32 is as torch leaves it (cuDNN's on): the head's
    convolutions turn it off themselves.  While they did not, the stacked
    step's grouped head convolution and a unit's own, both on cuDNN,
    parted by 5.8e-2 and 9.3e-2 of a gradient's largest in the f32 trunk
    (probes/stacked_step_diag.py on an H100), 3.9e-6 with TF32 off."""
    import copy

    from multilevel_gnn_tpu_torch.core.batch import Batch, stack_contexts
    from multilevel_gnn_tpu_torch.data.synthetic import make_gbm_scale_setup
    from multilevel_gnn_tpu_torch.nn.basic import UnitGenerators
    from multilevel_gnn_tpu_torch.ops.kernels import build
    from multilevel_gnn_tpu_torch.train import step as S

    assert torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    sets = [make_gbm_scale_setup(node_num=400, n_pathways=12, batch=8, gene_rows=900,
                                 topology="cohort", windowed=True, device=dev,
                                 compute_dtype=dtype, spmm_bf16=dtype is not None,
                                 seed=u, topo_seed=u) for u in range(3)]
    for s in sets:
        plan = s[2].winplan
        assert plan.n_tres > 0 and plan.res.nnz > 0, (plan.n_tres, plan.res.nnz)
    cfg = sets[0][0].replace(gnn_dropout=0.25)
    models = [s[1] for s in sets]
    sctx = stack_contexts([s[3] for s in sets])
    params = S.stack_params(models)
    opt = S.Optimizer(list(params.values()), cfg, 4, units=3)
    opt.step = lambda: None
    gens = UnitGenerators(torch.Generator(device=dev).manual_seed(7 + u) for u in range(3))
    batch = Batch(*(torch.stack([getattr(s[4], f) for s in sets])
                    for f in ("x", "y", "age", "sample_mask")))
    cw = torch.tensor([[1.0, 1.5]] * 3, device=dev)
    def counted(step):
        for k in build.REGISTRY.values():
            k.launches = 0
        step()
        return {k.name: k.launches for k in build.REGISTRY.values()}

    unit = copy.deepcopy(models[0])
    own = counted(lambda: S.train_step(
        unit, S.make_optimizer(unit, cfg, 4), sets[0][4], sets[0][3], cw[0],
        torch.Generator(device=dev).manual_seed(7)))
    counts = counted(lambda: S.stacked_train_step(
        copy.deepcopy(models[0]), params, opt, batch, sctx, cw, gens))
    assert counts[k1.KERNEL.name] == 7 and counts[k2.KERNEL.name] == 4, counts
    # the pathway contraction: PW in a unit's own step, the dense form under vmap
    assert own[pw.FWD_KERNEL.name] == 1 and own[pw.BWD_KERNEL.name] == 1, own
    assert counts == {**own, pw.FWD_KERNEL.name: 0, pw.BWD_KERNEL.name: 0}, (counts, own)
    tol = TOL[torch.bfloat16 if dtype else torch.float32] * 35
    for u, m in enumerate(models):
        m.train()
        m.zero_grad()
        loss, _ = S.make_loss_fn(cfg)(m, sets[u][4], sets[u][3], cw[u],
                                      torch.Generator(device=dev).manual_seed(7 + u))
        loss.backward()
        for name, p in m.named_parameters():
            if p.grad is None:
                continue
            err = float((params[name].grad[u] - p.grad).abs().max())
            assert err <= tol * float(p.grad.abs().max()) + 1e-30, (u, name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,te", [(165_888, 256), (4_097, 1024), (1_000, 256), (7, 3)])
def test_p1_matches_plain(dev, dtype, E, te):
    """P1 at the tool's shapes and with ragged, long and short chunks: the
    kernel against its plain version, two calls equal bit for bit, the 8
    rows equal, one launch a call."""
    N = 15_408
    rng = np.random.RandomState(0)
    x3 = torch.from_numpy(rng.randn(N, 16, 128).astype(np.float32)).to(dtype).to(dev)
    src = torch.from_numpy(rng.randint(0, N, E).astype(np.int32)).to(dev)
    p1.check_src(src, N)
    before = p1.KERNEL.launches
    out = p1.dma_row_gather(x3, src, te)
    again = p1.dma_row_gather(x3, src, te)
    torch.cuda.synchronize()
    assert p1.KERNEL.launches == before + 2
    _close(out, p1.dma_row_gather_plain(x3, src), torch.float32)
    assert torch.equal(out, again) and bool((out == out[:1]).all())


# E, te: the tool's shapes; E = 0; E < te; a short last chunk; 40 chunks
# (fewer than SMs); te = 1; te = 1,024; te 3 and 37 (not multiples of a
# slot's 2 or 4 rows)
P1_ORDER_CASES = [(165_888, 256), (0, 256), (100, 256), (1_000, 256), (10_240, 256),
                  (5_000, 1), (4_097, 1024), (7, 3), (10_001, 37)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,te", P1_ORDER_CASES)
def test_p1_equals_ordered(dev, dtype, E, te):
    """P1 in its own order of additions: equal bit for bit (f32 words) to
    dma_row_gather_ordered and to a second call, one launch a call."""
    N = 15_408
    rng = np.random.RandomState(0)
    x3 = torch.from_numpy(rng.randn(N, 16, 128).astype(np.float32)).to(dtype).to(dev)
    src = torch.from_numpy(rng.randint(0, N, E).astype(np.int32)).to(dev)
    before = p1.KERNEL.launches
    out = p1.dma_row_gather(x3, src, te)
    again = p1.dma_row_gather(x3, src, te)
    torch.cuda.synchronize()
    assert p1.KERNEL.launches == before + 2
    want = p1.dma_row_gather_ordered(x3, src, te)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32)), \
        float((out - want).abs().max())
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))


def test_p1_empty_src(dev):
    x3 = torch.randn(16, 16, 128, device=dev)
    out = p1.dma_row_gather(x3, torch.empty(0, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros(8, 128, device=dev))


# ---- PW: the pathway contraction (ops/kernels/pathway.py)

def _slot_ids(kind, G=25_015, S=438, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "kirc":  # the benchmark's synthetic fold: sorted, 35-81 rows a slot
        return np.sort(rng.randint(0, S, G))
    ids = rng.randint(0, S - 3, G)  # the last three slots empty
    ids[rng.choice(G, 1000, replace=False)] = 5  # 1,000+ rows: eight chunks
    return ids


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,F,kind", [(3, 2048, "kirc"), (2, 1024, "kirc"), (3, 64, "kirc"),
                                      (4, 20, "long"), (1, 2056, "long")])
def test_pw_matches_plain(dev, dtype, K, F, kind):
    ids = _slot_ids(kind)
    G, S = len(ids), 438
    plan = pw.SlotPlan.build(ids, S).to(dev)
    assert (plan.n_parts > 0) == (kind == "long")
    g = torch.Generator(device=dev).manual_seed(K * F)
    x = torch.randn(G, F, generator=g, device=dev).to(dtype)
    p = torch.randn(G, K, generator=g, device=dev)
    gout = torch.randn(K * S, F, generator=g, device=dev)
    f0, b0 = pw.FWD_KERNEL.launches, pw.BWD_KERNEL.launches
    out = pw.pathway_fwd(x, p, plan)
    dx, dp = pw.pathway_bwd(x, p, gout, plan)
    out2 = pw.pathway_fwd(x, p, plan)
    dx2, dp2 = pw.pathway_bwd(x, p, gout, plan)
    torch.cuda.synchronize()
    assert (pw.FWD_KERNEL.launches - f0, pw.BWD_KERNEL.launches - b0) == (2, 2)
    _close(out, pw.pathway_fwd_plain(x, p, plan), torch.float32)
    rdx, rdp = pw.pathway_bwd_plain(x, p, gout, plan)
    assert dx.dtype == dtype and torch.equal(dx, rdx), float((dx.float() - rdx.float()).abs().max())
    _close(dp, rdp, torch.float32)
    for a, b in ((out, out2), (dx, dx2), (dp, dp2)):
        assert torch.equal(a, b)


def test_pw_route_and_launches(dev, monkeypatch):
    """pathway_contract on the card: the PW kernels, neither the one-hot nor
    its weighted copy (slot_onehot and the dense Function refuse here);
    then a train step and an eval batch of a small windowed fold, counted."""
    from multilevel_gnn_tpu_torch.data.synthetic import make_gbm_scale_setup
    from multilevel_gnn_tpu_torch.ops import pathway as pathway_ops
    from multilevel_gnn_tpu_torch.ops.kernels import build
    from multilevel_gnn_tpu_torch.train import step as S

    def refuse(*a, **k):
        raise AssertionError("the dense form ran outside torch.vmap")

    monkeypatch.setattr(pathway_ops, "slot_onehot", refuse)
    monkeypatch.setattr(pathway_ops._Contract, "apply", refuse)
    cfg, model, graph, ctx, batch = make_gbm_scale_setup(
        node_num=400, n_pathways=12, batch=8, gene_rows=900, topology="cohort",
        windowed=True, device=dev, compute_dtype="bfloat16", spmm_bf16=True, seed=0,
        topo_seed=0)
    assert ctx.slot_plan is not None and ctx.slot_plan.slot_ptr.is_cuda

    def counted(fn):
        for k in build.REGISTRY.values():
            k.launches = 0
        fn()
        torch.cuda.synchronize()
        return {n: c for n, c in ((k.name, k.launches) for k in build.REGISTRY.values()) if c}

    cw = torch.tensor([1.0, 1.5], device=dev)
    step = counted(lambda: S.train_step(model, S.make_optimizer(model, cfg, 4), batch, ctx,
                                        cw, torch.Generator(device=dev).manual_seed(7)))
    assert step == {k1.KERNEL.name: 7, k2.KERNEL.name: 4, pw.FWD_KERNEL.name: 1,
                    pw.BWD_KERNEL.name: 1}, step
    ev = counted(lambda: S.eval_step(model, batch, ctx))
    assert ev == {k1.KERNEL.name: 2, k2.KERNEL.name: 2, pw.FWD_KERNEL.name: 1}, ev


def test_pw_refuses_other_k(dev):
    """The kernels are built for 1 to 4 PCA columns; a CUDA tensor with
    another K raises before any launch (the CPU's plain version takes any)."""
    plan = pw.SlotPlan.build(np.arange(40) % 6, 6).to(dev)
    x = torch.randn(40, 16, device=dev)
    before = pw.FWD_KERNEL.launches
    with pytest.raises(ValueError, match="PCA columns"):
        pw.pathway_fwd(x, torch.randn(40, 5, device=dev), plan)
    assert pw.FWD_KERNEL.launches == before
    out = pw.pathway_fwd(x.cpu(), torch.randn(40, 5), pw.SlotPlan.build(np.arange(40) % 6, 6))
    assert out.shape == (30, 16)
