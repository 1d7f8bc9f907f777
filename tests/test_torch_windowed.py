"""K2 (windowed SpMM, ops/kernels/windowed.py) of the PyTorch port against
the JAX package's windowed plan and windowed_spmm_2d (Pallas interpret).

Plan: on the same graph the port's build_plan / choose_node_perm give the
same node permutation, residual count, in-window fraction and residual
edge-id set as JAX's: required equal.  The port's plan also covers every
in-window edge exactly once.

Forward (plain versions on the CPU: K2 in-window + K1 residual) against
JAX windowed_spmm_2d on banded, random (heavy residual), permuted + masked
and empty graphs, and the transpose (windowed_spmm(transpose=True): K2 on
the transpose side + K1 over tres and res_csc) against its custom VJP's
backward rule.  Tolerances:
  f32:  rtol = atol = 1e-5.
  bf16, each (dst, src) pair once (the cases with repeated pairs cut to
        their first edge of each pair): max|port - jax| <= 1e-5 * max(1,
        max|jax|).  Both round each weight to bf16, so an entry's value is
        one bf16 weight and every product is exact in f32; only the f32
        sum order differs.
  bf16, repeated pairs: an entry's f32 sum of bf16 weights, taken in
        another order, can round to the neighbouring bf16 value, so the
        limit adds, per output element, the bf16 spacing at each repeated
        entry's value times |x| at its source.
  bf16 against JAX f32: max|port_bf16 - jax_f32| <= 1.5 * max|jax_bf16 -
        jax_f32| + 1e-3 (its own test).
Also: the blocks' per-row entry pointers against ent_pos, blocks split at
the entry cap, and the K2 plain version against a numpy loop.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multilevel_gnn_tpu.ops.pallas import windowed as JW
from multilevel_gnn_tpu_torch.ops.kernels import windowed as W
from torch_threads import few_threads  # noqa: F401  (autouse)


def _rand_graph(rng, n, e, banded=None):
    src = rng.randint(0, n, e)
    if banded is not None:
        dst = np.clip(src + rng.randint(-banded, banded + 1, e), 0, n - 1)
    else:
        dst = rng.randint(0, n, e)
    w = rng.randn(e).astype(np.float32)
    return src.astype(np.int64), dst.astype(np.int64), w


def _two_communities(rng, n, e):
    comm = rng.randint(0, 2, n)
    order = np.argsort(rng.rand(n))
    src, dst = [], []
    for _ in range(e):
        c = rng.randint(0, 2)
        nodes = order[comm[order] == c]
        src.append(nodes[rng.randint(len(nodes))])
        dst.append(nodes[rng.randint(len(nodes))])
    return np.array(src), np.array(dst), rng.randn(e).astype(np.float32)


def _jax_res_set(jp):
    r = np.asarray(jp.res_idx) if jp.res_idx is not None else np.zeros(0, int)
    return np.sort(r[r < jp.n_edges])


def _cases():
    rng = np.random.RandomState(0)
    out = []
    s, d, w = _rand_graph(rng, 700, 4000, banded=40)
    out.append(("banded", s, d, w, None, 256, 2, 1))
    s, d, w = _rand_graph(rng, 500, 3000)
    out.append(("random", s, d, w, None, 128, 1, 1))
    s, d, w = _two_communities(np.random.RandomState(1), 600, 3000)
    mask = np.random.RandomState(2).rand(len(s)) > 0.1
    out.append(("perm_mask", s, d, w, mask, 128, 2, 1))
    # gene-level communities in the 3*gene+omics interleave
    r3 = np.random.RandomState(3)
    gs, gd, w = _two_communities(r3, 200, 2000)
    om = r3.randint(0, 3, len(gs))
    out.append(("perm_group3", 3 * gs + om, 3 * gd + om, w, None, 128, 2, 3))
    out.append(("empty", np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32), None, 128, 2, 1))
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


def _plans(case):
    name, s, d, w, mask, Wb, nwin, group = case
    n = max(int(s.max()) + 1 if len(s) else 1, int(d.max()) + 1 if len(d) else 1)
    n = max(n, 300)
    sm = s[mask] if mask is not None else s
    dm = d[mask] if mask is not None else d
    jperm, jf_id, jf_best = JW.choose_node_perm(sm, dm, n, Wb=Wb, nwin=nwin, group=group)
    perm, f_id, f_best = W.choose_node_perm(sm, dm, n, Wb=Wb, nwin=nwin, group=group)
    assert (perm is None) == (jperm is None)
    if perm is not None:
        np.testing.assert_array_equal(perm, jperm)
    assert (f_id, f_best) == (jf_id, jf_best)
    jp = JW.build_plan(s, d, n, mask=mask, perm=jperm, Wb=Wb, nwin=nwin)
    pp = W.build_plan(s, d, n, mask=mask, perm=perm, Wb=Wb, nwin=nwin)
    return n, jp, pp


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plan_matches_jax(case):
    name, s, d, w, mask, Wb, nwin, group = case
    n, jp, pp = _plans(case)
    assert pp.n_res == int(jp.n_res)
    assert pp.in_window_frac == float(jp.in_window_frac)
    np.testing.assert_array_equal(pp.res_eid, _jax_res_set(jp))
    if name.startswith("perm"):
        assert pp.perm is not None and pp.row_of is not None
    # every kept edge is either in a window entry or residual, once
    kept = np.arange(len(s)) if mask is None else np.flatnonzero(mask)
    both = np.concatenate([pp.fwd.edge_eid.numpy(), pp.res_eid])
    np.testing.assert_array_equal(np.sort(both), kept)
    assert pp.fwd.tile_blk_ptr.numpy()[-1] == pp.fwd.n_blocks
    assert pp.fwd.blk_ent_ptr.numpy()[-1] == pp.fwd.n_entries
    assert pp.fwd.ent_edge_ptr.numpy()[-1] == pp.fwd.n_in


def _jax_fwd(x, w, s, d, jp, mask, bf16):
    wm = w if mask is None else w * mask
    xj = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    out = JW.windowed_spmm_2d(
        xj, jnp.asarray(wm[:, None]), jnp.asarray(s, jnp.int32),
        jnp.asarray(d, jnp.int32), jp,
    )
    return np.asarray(out, np.float64)


def _port_fwd(x, w, pp, bf16):
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
    out = W.windowed_spmm(xt, torch.from_numpy(w), pp)
    assert out.dtype == torch.float32
    return out.numpy().astype(np.float64)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_windowed_forward_f32_matches_jax(case):
    name, s, d, w, mask, Wb, nwin, group = case
    n, jp, pp = _plans(case)
    x = np.random.RandomState(5).randn(n, 48).astype(np.float32)
    ref = _jax_fwd(x, w, s, d, jp, mask, bf16=False)
    out = _port_fwd(x, w, pp, bf16=False)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES[1:3], ids=IDS[1:3])
def test_windowed_forward_bf16_within_bound(case):
    name, s, d, w, mask, Wb, nwin, group = case
    n, jp, pp = _plans(case)
    x = np.random.RandomState(6).randn(n, 32).astype(np.float32)
    j32 = _jax_fwd(x, w, s, d, jp, mask, bf16=False)
    j16 = _jax_fwd(x, w, s, d, jp, mask, bf16=True)
    p16 = _port_fwd(x, w, pp, bf16=True)
    assert np.abs(p16 - j32).max() <= 1.5 * np.abs(j16 - j32).max() + 1e-3


def _unique_pairs(case):
    """The case with each kept (dst, src) pair once: its first edge."""
    name, s, d, w, mask, Wb, nwin, group = case
    kept = np.arange(len(s)) if mask is None else np.flatnonzero(mask)
    _, first = np.unique(s[kept] * (len(s) + 1000) + d[kept], return_index=True)
    sel = kept[np.sort(first)]
    return (name, s[sel], d[sel], w[sel], None, Wb, nwin, group)


UNIQUE = [_unique_pairs(c) for c in CASES]


class _CastOnce:
    """The windowed VJP's dtype witness (windowed.py:757, :791-792) for a
    bf16 cotangent whose f32 gradient is kept: the first read casts the
    cotangent to bf16; the later ones see f32, so the sum is not cast."""

    def __init__(self):
        self.reads = 0

    @property
    def dtype(self):
        self.reads += 1
        return jnp.bfloat16 if self.reads == 1 else jnp.float32


def _jax_transpose(g, w, s, d, jp, mask, bf16):
    wm = w if mask is None else w * mask
    proto = _CastOnce() if bf16 else jnp.zeros((0,), jnp.float32)
    res = (jnp.asarray(wm[:, None]), jnp.asarray(s, jnp.int32),
           jnp.asarray(d, jnp.int32), jp, proto)
    return np.asarray(JW._wspmm_bwd(res, jnp.asarray(g))[0], np.float64)


def _port(x, w, pp, bf16, transpose):
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
    out = W.windowed_spmm(xt, torch.from_numpy(w), pp, transpose=transpose)
    assert out.dtype == torch.float32
    return out.numpy().astype(np.float64)


def _jax(x, w, s, d, jp, mask, bf16, transpose):
    if transpose:
        return _jax_transpose(x, w, s, d, jp, mask, bf16)
    return _jax_fwd(x, w, s, d, jp, mask, bf16)


@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "transpose"])
@pytest.mark.parametrize("case", UNIQUE, ids=IDS)
def test_windowed_bf16_matches_jax_bf16(case, transpose):
    name, s, d, w, mask, Wb, nwin, group = case
    n, jp, pp = _plans(case)
    x = np.random.RandomState(7).randn(n, 24).astype(np.float32)
    ref = _jax(x, w, s, d, jp, mask, True, transpose)
    out = _port(x, w, pp, True, transpose)
    assert np.abs(out - ref).max(initial=0.0) <= 1e-5 * max(1.0, np.abs(ref).max(initial=0.0))


def _repeat_limit(pp, w, x, transpose):
    """Per output element: the sum, over the entries with more than one
    edge, of the bf16 spacing at the entry's value times |x| at its source
    row (the most a neighbouring bf16 entry value can move the output)."""
    side = pp.bwd if transpose else pp.fwd
    ent = side.edge_ent.numpy()
    we = torch.from_numpy(w[side.edge_eid.numpy()]).to(torch.bfloat16).float().numpy()
    a = np.zeros(side.n_entries, np.float64)
    np.add.at(a, ent, we.astype(np.float64))
    rep = np.bincount(ent, minlength=side.n_entries) > 1
    spacing = np.where(a != 0, 2.0 ** (np.floor(np.log2(np.abs(a) + 1e-300)) - 7), 0.0)
    xb = np.abs(torch.from_numpy(x).to(torch.bfloat16).float().numpy().astype(np.float64))
    lim = np.zeros_like(xb)
    np.add.at(lim, side.ent_dst_orig.numpy()[rep],
              spacing[rep, None] * xb[side.ent_src_orig.numpy()[rep]])
    return lim, int(rep.sum())


@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "transpose"])
@pytest.mark.parametrize("case", CASES[:4], ids=IDS[:4])
def test_windowed_bf16_repeated_pairs_within_limit(case, transpose):
    name, s, d, w, mask, Wb, nwin, group = case
    n, jp, pp = _plans(case)
    x = np.random.RandomState(8).randn(n, 24).astype(np.float32)
    ref = _jax(x, w, s, d, jp, mask, True, transpose)
    out = _port(x, w, pp, True, transpose)
    lim, n_rep = _repeat_limit(pp, w, x, transpose)
    assert n_rep > 0
    assert np.all(np.abs(out - ref) <= lim + 1e-5 * max(1.0, np.abs(ref).max()))


def _dense_case():
    """A 128 x 128 block with every pair present (16,384 entries in one
    sub-block, split into blocks at the cap), plus banded edges."""
    rng = np.random.RandomState(9)
    s0, d0 = np.meshgrid(np.arange(128), np.arange(128))
    s1 = rng.randint(128, 700, 3000)
    d1 = np.clip(s1 + rng.randint(-30, 31, 3000), 128, 699)
    s = np.concatenate([s0.ravel(), s1]).astype(np.int64)
    d = np.concatenate([d0.ravel(), d1]).astype(np.int64)
    return 700, s, d, rng.randn(len(s)).astype(np.float32)


@pytest.mark.parametrize("case", CASES[:4] + ["dense"], ids=IDS[:4] + ["dense"])
def test_block_row_pointers_agree_with_entries(case):
    if case == "dense":
        n, s, d, _ = _dense_case()
        pp = W.build_plan(s, d, n, Wb=128, nwin=1)
        assert pp.fwd.n_blocks > 16  # the dense sub-block was split
    else:
        n, jp, pp = _plans(case)
    for side in (pp.fwd, pp.bwd):
        bp = side.blk_ent_ptr.numpy()
        rp = side.blk_row_ptr.numpy()
        pos = side.ent_pos.numpy()
        tp = side.tile_blk_ptr.numpy()
        assert rp.shape == (side.n_blocks, W.RP)
        assert np.all(np.diff(bp) <= W.ENT_CAP) and np.all(np.diff(bp) > 0)
        for b in range(side.n_blocks):
            r = rp[b]
            assert r[0] == 0 and np.all(r[W.TN:] == bp[b + 1] - bp[b])
            assert np.all(np.diff(r) >= 0)
            rows = np.repeat(np.arange(W.TN), np.diff(r[: W.TN + 1]))
            np.testing.assert_array_equal(pos[bp[b]:bp[b + 1]] // W.SB, rows)
        # each entry lies in its block's tile and source sub-block (in the
        # plan's permuted order)
        perm = pp.perm if pp.perm is not None else np.arange(n)
        blk_tile = np.repeat(np.arange(side.n_tiles), np.diff(tp))
        ent_blk = np.repeat(np.arange(side.n_blocks), np.diff(bp))
        np.testing.assert_array_equal(perm[side.ent_dst_orig.numpy()] // W.TN,
                                      blk_tile[ent_blk])
        np.testing.assert_array_equal(perm[side.ent_src_orig.numpy()] // W.SB,
                                      side.blk_src.numpy()[ent_blk] // W.SB)
        assert tp[-1] == side.n_blocks and bp[-1] == side.n_entries


def test_k2_plain_rounds_each_weight():
    """The plain version against a numpy loop: per entry, the f32 sum in
    plan order of the bf16-rounded weights, rounded to bf16 (bf16 x), or of
    the f32 weights (f32 x); then the weighted rows summed in float64."""
    n, s, d, w = _dense_case()
    s = np.concatenate([s, s[:500]])  # repeated pairs
    d = np.concatenate([d, d[:500]])
    w = np.concatenate([w, np.random.RandomState(10).randn(500).astype(np.float32)])
    pp = W.build_plan(s, d, n, Wb=128, nwin=2)
    x = np.random.RandomState(11).randn(n, 6).astype(np.float32)

    def bf(v):
        return torch.tensor(v, dtype=torch.float32).to(torch.bfloat16).float().item()

    side = pp.fwd
    eptr, eid = side.ent_edge_ptr.numpy(), side.edge_eid.numpy()
    for dt in (torch.bfloat16, torch.float32):
        xt = torch.from_numpy(x).to(dt)
        xr = xt.float().numpy().astype(np.float64)
        ref = np.zeros((n, 6))
        for e in range(side.n_entries):
            a = np.float32(0.0)
            for k in range(eptr[e], eptr[e + 1]):
                a = np.float32(a + np.float32(bf(w[eid[k]]) if dt == torch.bfloat16 else w[eid[k]]))
            if dt == torch.bfloat16:
                a = bf(a)
            ref[side.ent_dst_orig[e]] += float(a) * xr[side.ent_src_orig[e]]
        out = W.windowed_tile_spmm(xt, torch.from_numpy(w), pp).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_build_plan_rejects_unaligned_window():
    with pytest.raises(ValueError):
        W.build_plan(np.array([0]), np.array([1]), 10, Wb=100)
