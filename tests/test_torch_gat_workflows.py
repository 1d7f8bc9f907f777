"""The workflows around a GAT fold (gnn_name gat, the Config's default conv),
on the CPU, at small widths of gbm.yaml:

- run_experiment 1 run x 5 folds x 2 epochs against the JAX package, each
  fold starting from JAX's initial parameters (test_torch_experiment.py's
  InitCarrier): fold test scores within 1e-5, pooled AUC / ACC equal;
- an exported GAT fold (bf16 trunk, windowed: GAT's edge sums go through
  the mgtpu::segment_spmm_csr op's fake function when torch.export traces
  it) called after load_exported equals the live eval_step within 1e-6 x
  max(1, max|ref|);
- predict_fold from a GAT fold's checkpoint equals the live evaluate;
- one integrated_gradients call on that fold runs and is finite.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.data import loaders as jloaders
from multilevel_gnn_tpu.train import driver as jdriver
from multilevel_gnn_tpu_torch.core.batch import Batch
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.data import loaders
from multilevel_gnn_tpu_torch.data.synthetic import make_synthetic_cohort, write_reference_format
from multilevel_gnn_tpu_torch.train import driver, explain, export, predict
from multilevel_gnn_tpu_torch.train.step import eval_step
from test_torch_experiment import KW, InitCarrier, _close_scores, _paths, _spy_results
from torch_threads import few_threads  # noqa: F401  (autouse)

GBM = str(Path(__file__).resolve().parents[1] / "configs" / "gbm.yaml")
GAT = dict(KW, epochs=2, gnn_name="gat", final_head=2)
TOL_EXPORT = 1e-6


def test_run_experiment_gat_matches_jax(tmp_path, monkeypatch):
    d = str(tmp_path)
    write_reference_format(d, seed=4, cancer_type="gbm", n_patients=60, n_pathways=5)
    jc = jloaders.load_cohort_from_files(cfg=JConfig.from_yaml(GBM, **GAT), **_paths(d))
    cfg = Config.from_yaml(GBM, **GAT)
    pc = loaders.load_cohort_from_files(cfg=cfg, **_paths(d))
    carrier = InitCarrier(monkeypatch)
    jfolds = _spy_results(monkeypatch, jdriver)
    pfolds = _spy_results(monkeypatch, driver)
    jout = jdriver.run_experiment(jc.cfg, jc)
    pout = driver.run_experiment(cfg, pc, device="cpu")
    assert not carrier.params and len(jfolds) == len(pfolds) == 5
    for a, b in zip(pfolds, jfolds):
        _close_scores(a, b)
    assert pout["check_epochs"] == jout["check_epochs"]
    for key in ("auc", "acc", "auc_by_loss", "acc_by_loss"):
        assert pout[key] == jout[key], key


@pytest.fixture(scope="module")
def gat_fold(tmp_path_factory):
    """One trained GAT fold (bf16 trunk, windowed) with its checkpoint."""
    cfg = Config.from_yaml(GBM, **dict(GAT, compute_dtype="bfloat16", spmm_bf16=True,
                                       windowed_spmm=True, windowed_min_edges=0))
    cohort = make_synthetic_cohort(cfg, seed=3, n_patients=50, n_pathways=5)
    tr, va, te = driver.fold_indices(cohort.labels(), cfg, 1)
    fcfg, fold, X = driver.fold_setup(cfg, cohort, tr, 1, device="cpu")
    fcfg = fcfg.replace(pathway_num=cohort.n_pathways)
    assert fold.ctx.graph.winplan is not None
    model = driver._new_model(fcfg, fold.ctx, 5)
    d = str(tmp_path_factory.mktemp("gat_ckpt"))
    driver.run_fold(fcfg, fold.ctx, X, cohort.Y, cohort.ages, tr, va, te,
                    fold.class_weight, [2], model=model, run_i=0, fold_i=1, ckpt_dir=d)
    return dict(cfg=cfg, fcfg=fcfg, cohort=cohort, fold=fold, X=X, te=te, model=model, dir=d)


def test_exported_gat_fold_equals_live(gat_fold, tmp_path):
    g = gat_fold
    model, ctx, B = g["model"], g["fold"].ctx, g["fcfg"].batch_size
    program = export.export_program(model, ctx, B, g["X"].shape[1])
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert "mgtpu.segment_spmm_csr.default" in ops
    meta = {"batch_size": B, "n_nodes": g["X"].shape[1], "platforms": ["cpu"], "run": 0,
            "fold": 1, "n_tensors": len(program.state_dict) + len(program.constants),
            "cancer_type": "gbm", "model": "multilevel_gnn"}
    export.save_exported(str(tmp_path / "e"), {"program": program, "meta": meta})
    infer = export.load_exported(str(tmp_path / "e"))
    idx = g["te"][:B]
    x, age = g["X"][idx], g["cohort"].ages[idx]
    live, _ = eval_step(model, Batch(x=torch.as_tensor(x), y=torch.zeros(len(idx), 2),
                                     age=torch.as_tensor(age),
                                     sample_mask=torch.ones(len(idx), dtype=torch.bool)), ctx)
    got = infer(x, age)
    assert got.shape == live.shape
    lim = TOL_EXPORT * max(1.0, float(live.abs().max()))
    assert float((got - live).abs().max()) <= lim


def test_predict_from_gat_checkpoint_equals_live(gat_fold):
    g = gat_fold
    auc, acc, _, score, loss = driver.evaluate(g["model"], g["fold"].ctx, g["X"],
                                               g["cohort"].Y, g["cohort"].ages, g["te"],
                                               g["fcfg"].batch_size)
    res = predict.predict_fold(g["cfg"], g["cohort"], g["dir"], 0, 1, device="cpu")
    np.testing.assert_array_equal(res["prob"], score.astype(np.float64))
    np.testing.assert_equal((res["auc"], res["acc"], res["loss"]), (auc, acc, loss))


def test_integrated_gradients_of_a_gat_fold_runs(gat_fold):
    g = gat_fold
    idx = g["te"][:4]
    batch = Batch(x=torch.as_tensor(g["X"][idx]), y=torch.zeros(4, 2),
                  age=torch.as_tensor(g["cohort"].ages[idx]),
                  sample_mask=torch.ones(4, dtype=torch.bool))
    att = explain.integrated_gradients(g["model"], batch, g["fold"].ctx, steps=3)
    assert att.shape == batch.x.shape and bool(torch.isfinite(att).all())
    assert float(att.abs().max()) > 0
