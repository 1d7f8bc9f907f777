"""Print the PyTorch port's measured parity errors against the JAX package.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py [--protocol-only]

Runs the same inputs as the parity tests in tests/test_torch_*.py (CPU,
plain versions on the port side, Pallas interpret mode on the JAX side)
and prints one JSON line per module with the max abs error and, for bf16,
the bound the tests hold it to.  Not collected by pytest.
"""
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]
import pytest  # noqa: E402
import test_torch_backward as TB  # noqa: E402
import test_torch_driver as TD  # noqa: E402
import test_torch_maxconv as TMC  # noqa: E402
import test_torch_segment_max as T3  # noqa: E402
import test_torch_segment_sum as T1  # noqa: E402
import test_torch_slice as TS  # noqa: E402
import test_torch_train as TT  # noqa: E402
import test_torch_windowed as T2  # noqa: E402
import test_torch_cohort as TC  # noqa: E402
import test_torch_experiment as TE  # noqa: E402
import test_torch_sorted_segment as T4  # noqa: E402


def _emit(**kw):
    print(json.dumps(kw), flush=True)


def main():
    for case in T1.CASES:
        seed, n, e, pad, tail = case
        ei, attr, n, pad_to = T1._graph(seed, n, e, pad, tail)
        x = np.random.RandomState(seed + 10).randn(3, n, 16).astype(np.float32)
        j32 = T1._jax_spmm(ei, attr, n, pad_to, x, "mean", False)
        p32 = T1._port_spmm(ei, attr, n, pad_to, x, "mean", False)
        j16 = T1._jax_spmm(ei, attr, n, pad_to, x, "mean", True)
        p16 = T1._port_spmm(ei, attr, n, pad_to, x, "mean", True)
        _emit(module="K1 spmm_mean", case=list(case),
              f32_max_abs_err=float(np.abs(p32 - j32).max()),
              bf16_max_abs_err_vs_jax_f32=float(np.abs(p16 - j32).max()),
              bf16_bound=float(1.5 * np.abs(j16 - j32).max() + 1e-3))
    for case in T2.CASES:
        name, s, d, w, mask, Wb, nwin, group = case
        n, jp, pp = T2._plans(case)
        x = np.random.RandomState(5).randn(n, 48).astype(np.float32)
        j32 = T2._jax_fwd(x, w, s, d, jp, mask, False)
        p32 = T2._port_fwd(x, w, pp, False)
        j16 = T2._jax_fwd(x, w, s, d, jp, mask, True)
        p16 = T2._port_fwd(x, w, pp, True)
        _emit(module="K2 windowed_spmm", case=name, n_res=pp.n_res,
              in_window_frac=pp.in_window_frac,
              f32_max_abs_err=float(np.abs(p32 - j32).max()),
              bf16_max_abs_err_vs_jax_f32=float(np.abs(p16 - j32).max()),
              bf16_bound=float(1.5 * np.abs(j16 - j32).max() + 1e-3))
    fold = TS.fold.__wrapped__()
    f, h = TS._run(fold, False), TS._run(fold, True)
    _emit(module="slice MultilevelGNN eval", n_res=fold["pctx"].graph.winplan.n_res,
          f32_prob_max_abs_err=float(np.abs(f["pp"] - f["jp"]).max()),
          f32_loss_max_abs_err=float(np.abs(f["pl"] - f["jl"]).max()),
          bf16_prob_max_abs_err_vs_jax_f32=float(np.abs(h["pp"] - f["jp"]).max()),
          bf16_prob_bound=float(1.5 * np.abs(h["jp"] - f["jp"]).max() + 1e-3),
          auc_equal=f["pev"][0] == f["jev"][0], acc_equal=f["pev"][1] == f["jev"][1])
    r = TS._run(fold, False, reorder=True)
    _emit(module="slice MultilevelGNN eval, pathway reorder",
          f32_prob_max_abs_err=float(np.abs(r["pp"] - r["jp"]).max()),
          f32_loss_max_abs_err=float(np.abs(r["pl"] - r["jl"]).max()))
    backward()
    training(fold)
    max_aggregation(fold)


def backward():
    for case in TB.CASES:
        name, s, d, w, mask, Wb, nwin, group = case
        n, jp, pp = T2._plans(case)
        rng = np.random.RandomState(21)
        x = rng.randn(n, 40).astype(np.float32)
        g = rng.randn(n, 40).astype(np.float32)
        j32 = TB._jax_bwd(x, g, w, s, d, jp, mask, False)
        p32 = TB._port_bwd(g, w, pp, False)
        j16 = TB._jax_bwd(x, g, w, s, d, jp, mask, True)
        p16 = TB._port_bwd(g, w, pp, True)
        _emit(module="K2+K1 windowed backward", case=name, n_tres=pp.n_tres,
              n_res=pp.n_res, bwd_n_in=pp.bwd.n_in,
              f32_max_abs_err=float(np.abs(p32 - j32).max()) if p32.size else 0.0,
              bf16_max_abs_err_vs_jax_f32=float(np.abs(p16 - j32).max()) if p16.size else 0.0,
              bf16_bound=float(1.5 * np.abs(j16 - j32).max() + 1e-3) if j16.size else 1e-3)
    for windowed in (False, True):
        n, jg, pg = TB._graphs(windowed)
        rng = np.random.RandomState(41)
        x = rng.randn(3, n, 12).astype(np.float32)
        g = rng.randn(3, n, 12).astype(np.float32)
        j32 = TB._jax_spmm_grad(jg, x, g, False)
        j16 = TB._jax_spmm_grad(jg, x, g, True)
        _emit(module="spmm_mean autograd", path="windowed" if windowed else "composed",
              f32_max_abs_err=float(np.abs(TB._port_spmm_grad(pg, x, g, False) - j32).max()),
              bf16_max_abs_err_vs_jax_f32=float(
                  np.abs(TB._port_spmm_grad(pg, x, g, True) - j32).max()),
              bf16_bound=float(1.5 * np.abs(j16 - j32).max() + 1e-3))
    dx, ref = TB.gather_rows_grads()
    _emit(module="gather_rows backward", f32_max_abs_err=float(np.abs(dx - ref).max()))


def training(fold):
    for windowed in (True, False):
        jl, pl, model, ref, _, grad0 = TT._train(fold, bf16=False, windowed=windowed)
        want = dict(ref.named_parameters())
        dp = dc = 0.0
        for k, p in model.named_parameters():
            diff = (p - want[k]).abs().detach()
            dp = max(dp, float(diff.max()))
            g = grad0[k].abs()
            clear = g > 1e-3 * float(g.max())
            if bool(clear.any()):
                dc = max(dc, float(diff[clear].max()))
        _emit(module="five train steps, f32", path="windowed" if windowed else "composed",
              loss_max_abs_err=float(np.abs(pl - jl).max()),
              param_max_abs_err=dp, param_bound=2 * TT.LR * TT.STEPS,
              param_max_abs_err_clear_grad=dc, param_bound_clear_grad=1e-5)
    j32, _, _, _, _, _ = TT._train(fold, bf16=False, windowed=True)
    j16, p16, _, _, _, _ = TT._train(fold, bf16=True, windowed=True)
    _emit(module="five train steps, bf16 trunk",
          loss_max_abs_err_vs_jax_f32=float(np.abs(p16 - j32).max()),
          bound=float(1.5 * np.abs(j16 - j32).max() + 1e-3))
    mp = pytest.MonkeyPatch()
    try:
        jf = TD.run_jax_fold(mp)
    finally:
        mp.undo()
    res = TD.run_port_fold(jf)
    jr = jf["res"]
    _emit(module="run_fold, 3 epochs, f32",
          valid_loss_max_abs_err=max(abs(p[2] - j[4])
                                     for p, j in zip(res.epoch_valid, jf["valid"])),
          valid_auc_equal=all(p[0] == j[0] for p, j in zip(res.epoch_valid, jf["valid"])),
          test_score_max_abs_err=max(
              float(np.abs(getattr(res, k)[e] - getattr(jr, k)[e]).max())
              for k in ("epoch_pred", "epoch_pred_by_loss", "epoch_pred_by_epoch")
              for e in TD.CHECK))



def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def max_aggregation(fold):
    import jax.numpy as jnp
    import torch
    from multilevel_gnn_tpu.ops import spmm as jspmm
    from multilevel_gnn_tpu.ops.pallas import segment_max as pmax
    from multilevel_gnn_tpu_torch.ops import spmm

    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    try:
        for case, name in zip(T3.CASES, T3.IDS):
            n, jg, pg = T3._graphs(case)
            data = T3._rows(pg, 20, seed=case[0])
            errs = {}
            for dt in ("float32", "bfloat16"):
                ref = pmax.segment_max_by(jnp.asarray(data, getattr(jnp, dt)), jg.csr)
                out = T3.segment_max_csr(
                    torch.from_numpy(data).to(getattr(torch, dt)), pg.csr)
                errs[dt] = _err(out.numpy(), ref)
            E = pg.num_padded_edges
            m = T3._rows(pg, 10, seed=7, ties=True).reshape(E, 2, 5)
            g = np.random.RandomState(8).randn(n, 2, 5).astype(np.float32)
            jo, jd = T3._esm_jax(jspmm.edge_segment_max,
                                 jnp.asarray(m.transpose(1, 0, 2), jnp.bfloat16),
                                 jnp.asarray(g.transpose(1, 0, 2)), jg)
            po, pd = T3._esm_port(spmm.edge_segment_max,
                                  torch.from_numpy(m).to(torch.bfloat16),
                                  torch.from_numpy(g), pg)
            _emit(module="K3 segment_max_csr vs segment_max_by", case=name,
                  f32_max_abs_err=errs["float32"], bf16_max_abs_err=errs["bfloat16"],
                  edge_segment_max_bf16_ties_fwd_err=_err(po.transpose(1, 0, 2), jo),
                  edge_segment_max_bf16_ties_grad_err=_err(pd.transpose(1, 0, 2), jd),
                  tied_edges_with_grad=int(np.count_nonzero(pd)),
                  rows_x_features_with_max=int(np.count_nonzero(po)))
    finally:
        jspmm.set_backend(prev)
    for conv in TMC.CONVS:
        (po, pdx, pgr), (jo, jdx, jgr) = TMC._layer_grads(conv, True, False)
        (p16, pdx16, pgr16), (j16, jdx16, jgr16) = TMC._layer_grads(conv, True, True)
        _emit(module=f"GraphConvLayer {conv}, f32", out_err=_err(po, jo),
              dx_err=_err(pdx, jdx), param_grad_err=max(_err(pgr[k], jgr[k]) for k in pgr),
              bf16_out_err_vs_jax_f32=_err(p16, jo),
              bf16_out_bound=float(1.5 * np.abs(j16 - jo).max() + 1e-3),
              bf16_dx_err_vs_jax_f32=_err(pdx16, jdx),
              bf16_dx_bound=float(1.5 * np.abs(jdx16 - jdx).max() + 1e-3))
        f, h = TS._run(fold, False, gnn_name=conv), TS._run(fold, True, gnn_name=conv)
        _emit(module=f"MultilevelGNN {conv} eval",
              f32_prob_max_abs_err=_err(f["pp"], f["jp"]),
              f32_loss_max_abs_err=_err(f["pl"], f["jl"]),
              bf16_prob_max_abs_err_vs_jax_f32=_err(h["pp"], f["jp"]),
              bf16_prob_bound=float(1.5 * np.abs(h["jp"] - f["jp"]).max() + 1e-3),
              bf16_loss_max_abs_err_vs_jax_f32=_err(h["pl"], f["jl"]),
              bf16_loss_bound=float(1.5 * np.abs(h["jl"] - f["jl"]).max() + 1e-3))
        jl, pl, model, ref, _, grad0 = TT._train(fold, bf16=False, windowed=True,
                                                 gnn_name=conv)
        want = dict(ref.named_parameters())
        dp = dc = 0.0
        for k, p in model.named_parameters():
            diff = (p - want[k]).abs().detach()
            dp = max(dp, float(diff.max()))
            gg = grad0[k].abs()
            clear = gg > 1e-3 * float(gg.max())
            if bool(clear.any()):
                dc = max(dc, float(diff[clear].max()))
        _emit(module=f"five train steps, {conv}, f32", loss_max_abs_err=_err(pl, jl),
              param_max_abs_err=dp, param_bound=2 * TT.LR * TT.STEPS,
              param_max_abs_err_clear_grad=dc, param_bound_clear_grad=1e-5)


def protocol(tmp):
    """K4's plain version against JAX; the cohort and fold derivation per
    shipped config; run_experiment (1 x 5 folds x 5 epochs) against JAX."""
    import jax.numpy as jnp
    import torch
    from multilevel_gnn_tpu.ops.pallas import segment_sum as jseg
    from multilevel_gnn_tpu_torch.ops.kernels import segment_sum as pseg
    from multilevel_gnn_tpu_torch.data.synthetic import write_reference_format
    from multilevel_gnn_tpu.train import driver as jdriver
    from multilevel_gnn_tpu_torch.train import driver as pdriver
    from multilevel_gnn_tpu_torch.train.driver import stratified_kfold

    rng = np.random.RandomState(0)
    for E, N, C, B in [(700, 300, 64, 1), (1000, 150, 96, 3), (50, 700, 130, 2)]:
        ids = rng.randint(-1, N, size=E)
        seg, plan = jseg.SortedSegments.build(ids, N), pseg.SortedPlan.build(ids, N)
        row = {}
        for dt in ("float32", "bfloat16"):
            t, j = T4._data(rng, (B, E, C), dt)
            want = np.asarray(jseg.segment_sum_by(j, seg, interpret=True))
            row[dt] = _err(pseg.segment_sum_by(t, plan).numpy(), want)
            row[dt + "_2d"] = _err(pseg.segment_sum_by(t[0], plan).numpy(),
                                   np.asarray(jseg.segment_sum_by(j[0], seg, interpret=True)))
            row[dt + "_ref_max"] = float(np.abs(want).max())
        _emit(module=f"K4 segment_sum_by (E,N,C,B)={(E, N, C, B)}", **row)
    d = os.path.join(tmp, "ref")
    write_reference_format(d, seed=5, n_patients=60, n_pathways=6)
    for name in ("gbm", "kirc", "lgg"):
        jc, pc = TC._load_both(d, name)
        labels = pc.labels()
        tune, _ = stratified_kfold(labels, 5, pc.cfg.split_shaffle, pc.cfg.split_seed)[1]
        tr = tune[stratified_kfold(labels[tune], 5, pc.cfg.split_shaffle,
                                   pc.cfg.split_seed)[0][0]]
        jf, pf = jc.fold(tr, 1), pc.fold(tr, 1, device="cpu")
        _emit(module=f"cohort + fold 1, {name}", features_err=_err(pc.X, jc.X),
              mi_err=_err(pf.mutual_info, jf.mutual_info),
              pca_seed_err=_err(pf.pca_seed, jf.pca_seed),
              mask_equal=bool((pf.info_mask == jf.info_mask).all()),
              mask_on=float(pf.info_mask.mean()),
              reorder_equal=bool(np.array_equal(pf.reorder_idxs, jf.reorder_idxs)),
              edges_equal=bool(np.array_equal(pf.ctx.graph.senders.numpy(),
                                              np.asarray(jf.ctx.graph.senders))
                               and np.array_equal(pf.ctx.graph.receivers.numpy(),
                                                  np.asarray(jf.ctx.graph.receivers))),
              real_edges=pf.edge_count)
    setup = TE.build_setup(os.path.join(tmp, "exp"))
    mp = pytest.MonkeyPatch()
    try:
        carrier = TE.InitCarrier(mp)
        jf = TE._spy_results(mp, jdriver)
        pf = TE._spy_results(mp, pdriver)
        jout = jdriver.run_experiment(setup["jcohort"].cfg, setup["jcohort"])
        pout = pdriver.run_experiment(setup["cfg"], setup["cohort"], device="cpu")
        assert not carrier.params
    finally:
        mp.undo()
    err = max(_err(getattr(a, k)[5], getattr(b, k)[5]) for a, b in zip(pf, jf)
              for k in ("epoch_pred", "epoch_pred_by_loss", "epoch_pred_by_epoch"))
    _emit(module="run_experiment 1 x 5 folds x 5 epochs, f32", fold_test_score_err=err,
          pooled_auc_port=pout["auc"][5], pooled_auc_jax=jout["auc"][5],
          pooled_acc_port=pout["acc"][5], pooled_acc_jax=jout["acc"][5])


if __name__ == "__main__":
    import tempfile

    if "--protocol-only" not in sys.argv:
        main()
    with tempfile.TemporaryDirectory() as tmp:
        protocol(tmp)
