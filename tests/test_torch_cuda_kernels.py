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
cap.  Integrated gradients with K1 / K2 against the same with the plain
versions (windowed and composed, bf16 and f32, same tolerances), and a
checkpoint written on the card loaded on the CPU and on the card.  The
mgtpu custom ops: torch.library.opcheck on CUDA tensors and each op's CUDA
kernel against its plain version (test_torch_ops.py's cases); a small bf16
windowed fold exported on the card and loaded in a fresh process (equal
to the live eval within 1e-6 x max(1, max|ref|), the same K1 / K2
launches); warm_experiment building every kernel and data library.

Tolerance: max|kernel - plain| <= tol * max(1, max|plain|), tol = 1e-4 for
f32 (sum order) and 2e-3 for bf16 (an entry's bf16 rounding can differ when
its f32 sum is taken in another order).  K3 is held to equality: a max
selects one of its inputs.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

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
        assert plan.long_rows.tolist() == [7]
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
    assert plan.n_busy == 0 and plan.long_rows.tolist() == [3, 1000, 9999]
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
    the same inputs (K3 equal)."""
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
