"""Print the PyTorch port's measured parity errors against the JAX package.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py \
        [--protocol-only | --repairs-only | --bf16-workflows-only | --export-sources-only]

Runs the same inputs as the parity tests in tests/test_torch_*.py (CPU,
plain versions on the port side, Pallas interpret mode on the JAX side)
and prints one JSON line per module with the max abs error and the
tolerance the tests hold it to (bf16 against JAX's bf16).  Not collected
by pytest.
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
          bf16_prob_max_abs_err_vs_jax_bf16=float(np.abs(h["pp"] - h["jp"]).max()),
          bf16_image_max_abs_err_vs_jax_bf16=float(np.abs(h["pimg"] - h["jimg"]).max()),
          bf16_tol=TS.TOL_BF16,
          auc_equal=f["pev"][0] == f["jev"][0], acc_equal=f["pev"][1] == f["jev"][1])
    r = TS._run(fold, False, reorder=True)
    _emit(module="slice MultilevelGNN eval, pathway reorder",
          f32_prob_max_abs_err=float(np.abs(r["pp"] - r["jp"]).max()),
          f32_loss_max_abs_err=float(np.abs(r["pl"] - r["jl"]).max()))
    backward()
    training(fold)
    max_aggregation(fold)


def repairs():
    """bf16 SpMMs against JAX's bf16 output (both round the edge weights):
    K1 composed (sum, mean), the windowed forward and transpose on the
    cases with each pair once, and on those with repeated pairs beside
    their limit; the CSV reader against pandas on a written cohort."""
    import pandas as pd
    import tempfile
    from multilevel_gnn_tpu_torch.data import loaders, synthetic

    for case in T1.CASES:
        seed, n, e, pad, tail = case
        ei, attr, n, pad_to = T1._graph(seed, n, e, pad, tail)
        x = np.random.RandomState(seed + 30).randn(3, n, 16).astype(np.float32)
        row = {}
        for reduce in ("sum", "mean"):
            ref = T1._jax_spmm(ei, attr, n, pad_to, x, reduce, True)
            out = T1._port_spmm(ei, attr, n, pad_to, x, reduce, True)
            row[f"{reduce}_err"] = _err(out, ref)
            row[f"{reduce}_limit"] = 1e-5 * max(1.0, float(np.abs(ref).max()))
        _emit(module="K1 composed bf16 vs JAX bf16", case=list(case), **row)
    for unique, case in zip(T2.UNIQUE, T2.CASES):
        for transpose in (False, True):
            name, s, d, w, mask, Wb, nwin, group = unique
            n, jp, pp = T2._plans(unique)
            x = np.random.RandomState(7).randn(n, 24).astype(np.float32)
            ref = T2._jax(x, w, s, d, jp, mask, True, transpose)
            row = dict(unique_err=_err(T2._port(x, w, pp, True, transpose), ref),
                       unique_limit=1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0))))
            if name != "empty":
                name, s, d, w, mask, Wb, nwin, group = case
                n, jp, pp = T2._plans(case)
                x = np.random.RandomState(8).randn(n, 24).astype(np.float32)
                ref = T2._jax(x, w, s, d, jp, mask, True, transpose)
                diff = np.abs(T2._port(x, w, pp, True, transpose) - ref)
                lim, n_rep = T2._repeat_limit(pp, w, x, transpose)
                row.update(repeated_entries=n_rep, repeated_err=float(diff.max()),
                           repeated_worst_share_of_limit=float(
                               (diff / (lim + 1e-5 * max(1.0, np.abs(ref).max()))).max()))
            _emit(module="K2 windowed bf16 vs JAX bf16", case=name,
                  side="transpose" if transpose else "forward", **row)
    with tempfile.TemporaryDirectory() as d:
        synthetic.write_reference_format(d, seed=5, n_patients=60, n_pathways=6)
        port = loaders.read_omics_csv(f"{d}/raw_mrna.csv").values
        ref = pd.read_csv(f"{d}/raw_mrna.csv", index_col=0).to_numpy()
        written = synthetic.make_synthetic_tables(seed=5, n_patients=60,
                                                  n_pathways=6)[0]["mrna"].values
        _emit(module="omics CSV reader vs pandas.read_csv", values=int(port.size),
              bits_equal=bool(np.array_equal(port, ref)),
              fields_off_correct_rounding=int((port != written).sum()),
              max_rel_off_correct_rounding=float(
                  (np.abs(port - written) / np.abs(written)).max()))


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
              bf16_max_abs_err_vs_jax_bf16=float(np.abs(p16 - j16).max()) if p16.size else 0.0,
              bf16_max_abs_err_vs_jax_f32=float(np.abs(p16 - j32).max()) if p16.size else 0.0,
              bf16_bound=float(1.5 * np.abs(j16 - j32).max() + 1e-3) if j16.size else 1e-3)
    for windowed in (False, True):
        n, jg, pg = TB._graphs(windowed)
        rng = np.random.RandomState(41)
        x = rng.randn(3, n, 12).astype(np.float32)
        g = rng.randn(3, n, 12).astype(np.float32)
        j32 = TB._jax_spmm_grad(jg, x, g, False)
        j16 = TB._jax_spmm_grad(jg, x, g, True)
        p16 = TB._port_spmm_grad(pg, x, g, True)
        _emit(module="spmm_mean autograd", path="windowed" if windowed else "composed",
              f32_max_abs_err=float(np.abs(TB._port_spmm_grad(pg, x, g, False) - j32).max()),
              bf16_max_abs_err_vs_jax_bf16=float(np.abs(p16 - j16).max()),
              bf16_max_abs_err_vs_jax_f32=float(np.abs(p16 - j32).max()),
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
    j16, p16, _, _, _, _ = TT._train(fold, bf16=True, windowed=True)
    _emit(module="five train steps, bf16 trunk",
          loss_max_abs_err_vs_jax_bf16=float(np.abs(p16 - j16).max()),
          tol=TT.TOL_BF16_LOSS)
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
              bf16_prob_max_abs_err_vs_jax_bf16=_err(h["pp"], h["jp"]),
              bf16_image_max_abs_err_vs_jax_bf16=_err(h["pimg"], h["jimg"]),
              bf16_loss_max_abs_err_vs_jax_bf16=_err(h["pl"], h["jl"]))
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


def bf16_workflows(tmp):
    """The bf16 trunk against JAX's bf16 trunk (eval, five
    steps, first-step gradients per parameter), integrated gradients, the
    optimizers and the KM screen against JAX, and run_experiment under
    kirc / lgg and against JAX's fold-scan path."""
    import dataclasses

    import test_torch_explain as TX
    import test_torch_optim as TO
    fold = TS.fold.__wrapped__()
    for conv in ("sage", "mr", "edge"):
        h = TS._run(fold, True, gnn_name=conv)
        _emit(module=f"bf16 eval vs JAX bf16, {conv}",
              prob_err=_err(h["pp"], h["jp"]), loss_err=_err(h["pl"], h["jl"]),
              image_err=_err(h["pimg"], h["jimg"]), tol=TS.TOL_BF16)
        j16, p16, _, _, _, _ = TT._train(fold, bf16=True, windowed=True, gnn_name=conv)
        _emit(module=f"five bf16 train steps vs JAX bf16, {conv}",
              loss_err=_err(p16, j16), tol=TT.TOL_BF16_LOSS)
        for windowed in ((True, False) if conv == "sage" else (False,)):
            jg, pg = TT._first_grads(fold, windowed, gnn_name=conv)
            rel = {k: float(np.abs(pg[k] - g).max() / max(np.abs(g).max(), 1e-30))
                   for k, g in jg.items()}
            _emit(module=f"first bf16 step's gradients vs JAX bf16, {conv}",
                  path="windowed" if windowed else "composed",
                  worst_other=max(v for k, v in rel.items()
                                  if k not in TT.BF16_GRAD_RESIDUE),
                  rel_by_param={k: v for k, v in rel.items() if v > 1e-6},
                  tol=TT.TOL_BF16_GRAD, residue_tol=TT.BF16_GRAD_RESIDUE)
    for windowed in (True, False):
        jctx, pctx = fold["jctx"], fold["pctx"]
        if not windowed:
            jctx = dataclasses.replace(jctx, graph=dataclasses.replace(jctx.graph, winplan=None))
            pctx = dataclasses.replace(pctx, graph=dataclasses.replace(pctx.graph, winplan=None))
        errs = _ig_errs(TX, fold, jctx, pctx)
        _emit(module="integrated_gradients f32", path="windowed" if windowed else "composed",
              **errs, tol_rel=1e-5)
    for name in ("radam", "adamw"):
        for kw, tag in ((TO.ON, "clip_warmup_steplr_wd"), (TO.OFF, "plain")):
            _emit(module=f"{name} vs optax, 10 updates", case=tag,
                  param_max_abs_err=_optim_err(TO, name, kw), tol=1e-6)
    perr = 0.0
    for seed in range(3):
        scores, times, events, names = TX._survival(seed)
        for g, w in zip(TX.survival.pathway_km_screen(scores, times, events, names),
                        TX.jsurv.pathway_km_screen(scores, times, events, names)):
            perr = max(perr, abs(g["p"] - w["p"]))
    _emit(module="pathway_km_screen vs JAX", p_max_abs_err=perr, tol=1e-12)
    for name in ("kirc", "lgg", "gbm fold-scan"):
        setup = TE.build_setup(os.path.join(tmp, name.split()[0]), name.split()[0])
        jkw = dict(epoch_scan=True, fold_scan=True) if "scan" in name else {}
        mp = pytest.MonkeyPatch()
        try:
            TE.InitCarrier(mp)
            from multilevel_gnn_tpu.train import driver as jdriver
            from multilevel_gnn_tpu_torch.train import driver as pdriver
            jf = TE._spy_results(mp, jdriver)
            pf = TE._spy_results(mp, pdriver)
            jout = jdriver.run_experiment(setup["jcohort"].cfg.replace(**jkw), setup["jcohort"])
            pout = pdriver.run_experiment(setup["cfg"], setup["cohort"], device="cpu")
        finally:
            mp.undo()
        e = jout["check_epochs"][-1]
        err = max(_err(getattr(a, k)[e], getattr(b, k)[e]) for a, b in zip(pf, jf)
                  for k in ("epoch_pred", "epoch_pred_by_loss", "epoch_pred_by_epoch"))
        _emit(module=f"run_experiment {name}, f32", fold_test_score_err=err,
              pooled_auc_equal=pout["auc"] == jout["auc"],
              pooled_acc_equal=pout["acc"] == jout["acc"])


def export_sources(tmp):
    """Exported inference against JAX's export, the merge model, the PPI /
    merge protocols, kraskov_mi and edge_select against JAX."""
    import pathlib

    import test_torch_export as TXP
    import test_torch_merge as TM
    import test_torch_ppi as TP
    from multilevel_gnn_tpu.train import driver as jdriver
    from multilevel_gnn_tpu_torch.train import driver as pdriver

    for name, kw in (("f32", TXP.KW), ("bf16 trunk, windowed", TXP.BF16)):
        d = pathlib.Path(tmp) / f"export_{name.split()[0]}"
        d.mkdir()
        got, want, _, _ = TXP.export_pair(d, kw)
        _emit(module=f"exported artifact (fresh process) vs JAX export, {name}",
              prob_err=_err(np.asarray(got["probs"]), want), tol=TXP.TOL,
              port_modules_loaded=got["port_modules"])
    fold = TM.merge_fold.__wrapped__(TS.fold.__wrapped__())
    for bf16 in (False, True):
        rows, _ = TM.merge_eval(fold, bf16)
        pl, jl = TM.merge_train(fold, bf16)
        _emit(module=f"merge MultilevelGNN, {'bf16 vs JAX bf16' if bf16 else 'f32'}",
              prob_err=max(_err(r[0], r[1]) for r in rows),
              loss_err=max(abs(r[2] - r[3]) for r in rows), eval_tol=TM.TOL,
              five_step_loss_err=_err(pl, jl),
              five_step_tol=TM.TOL_BF16_LOSS if bf16 else TM.TOL)
    for edge_type in ("ppi", "merge"):
        setup = TM.build_protocol(os.path.join(tmp, edge_type), edge_type)
        mp = pytest.MonkeyPatch()
        try:
            TE.InitCarrier(mp)
            jf = TE._spy_results(mp, jdriver)
            pf = TE._spy_results(mp, pdriver)
            jout = jdriver.run_experiment(setup["jcohort"].cfg, setup["jcohort"])
            pout = pdriver.run_experiment(setup["cfg"], setup["cohort"], device="cpu")
        finally:
            mp.undo()
        err = max(_err(getattr(a, k)[5], getattr(b, k)[5]) for a, b in zip(pf, jf)
                  for k in ("epoch_pred", "epoch_pred_by_loss", "epoch_pred_by_epoch"))
        _emit(module=f"run_experiment edge_type {edge_type}, f32", fold_test_score_err=err,
              pooled_auc_equal=pout["auc"] == jout["auc"],
              pooled_acc_equal=pout["acc"] == jout["acc"], tol=TE.TOL)
    rel = 0.0
    for n, dx, seed in ((30, 2, 0), (57, 1, 1), (120, 2, 2), (200, 1, 3)):
        rng = np.random.RandomState(seed)
        x = np.round(rng.randn(n, dx), 1)
        y = rng.randint(0, 2, (n, 1)).astype(float)
        for xx in (x, x[:, :1]):
            want = TP.jkraskov(xx, y)
            if want > 0:
                rel = max(rel, abs(TP.kraskov_mi(xx, y) - want) / want)
    _emit(module="kraskov_mi vs JAX (cKDTree, scipy digamma)", max_rel_err=rel, tol=1e-12)


def _ig_errs(TX, fold, jctx, pctx):
    import flax
    from multilevel_gnn_tpu.ops import spmm as jspmm
    from multilevel_gnn_tpu_torch.interop import load_flax_params

    kw = TS._cfg_dict()
    jmodel = TX.JModel(TX.JConfig.from_dict(kw))
    jb = next(iter(TX.j_iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(TS.P),
                                     TS.B, np.random.RandomState(0), False, False)))
    jspmm.set_backend("pallas")
    try:
        params = jmodel.init(jax.random.PRNGKey(0), jb, jctx, False)
        jig = np.asarray(TX.jexplain.integrated_gradients(jmodel, params, jb, jctx,
                                                          steps=TX.STEPS))
    finally:
        jspmm.set_backend("xla")
    model = TX.MultilevelGNN(TX.Config.from_dict(kw), fold["n"], TS.G, device="cpu")
    load_flax_params(model, {k: np.asarray(v) for k, v in
                             flax.traverse_util.flatten_dict(params, sep="/").items()})
    pb = next(iter(TX.iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(TS.P),
                                   TS.B, "cpu")))
    pig = TX.explain.integrated_gradients(model, pb, pctx, steps=TX.STEPS).numpy()
    return {"max_abs_err": _err(pig, jig), "ref_max": float(np.abs(jig).max())}


def _optim_err(TO, name, kw):
    import jax.numpy as jnp
    import optax

    init, grads = TO._data()
    tx = TO.jstep.make_optimizer(TO.JConfig(**kw), TO.SPE, name=name)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    module = TO._module(init)
    opt = TO.pstep.make_optimizer(module, TO.Config(**kw), TO.SPE, name=name)
    err = 0.0
    for gr in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in gr.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        TO._step(module, opt, gr)
        err = max(err, max(_err(getattr(module, k).detach().numpy(), np.asarray(jp[k]))
                           for k in TO.SHAPES))
    return err


if __name__ == "__main__":
    import tempfile

    if "--export-sources-only" in sys.argv:
        with tempfile.TemporaryDirectory() as tmp:
            export_sources(tmp)
        sys.exit(0)
    if "--bf16-workflows-only" in sys.argv:
        with tempfile.TemporaryDirectory() as tmp:
            bf16_workflows(tmp)
        sys.exit(0)
    if "--repairs-only" in sys.argv:
        repairs()
        sys.exit(0)
    if "--protocol-only" not in sys.argv:
        main()
        repairs()
    with tempfile.TemporaryDirectory() as tmp:
        protocol(tmp)
