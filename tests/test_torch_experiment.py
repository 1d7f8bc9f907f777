"""The port's CV protocol against the JAX package's, on the CPU.

One tiny cohort is written by the port's write_reference_format and loaded
by both packages' load_cohort_from_files (the JAX side with pandas'
round-trip float parser, so both start from the same values; see
test_torch_cohort.py), with gbm.yaml at small widths, an f32 trunk and
dropout off.  Each fold's initial parameters are JAX's, carried into the
port by replacing driver._new_model (the JAX package's init, read where it
hands them to seed_pca_params); PCA seeding, batches and training are each
package's own.

- run_fold at the seeds of run 1, fold 2: the test scores at every check
  epoch within 1e-5 of JAX's.
- run_experiment, 1 run x 5 folds x 5 epochs: every fold's test scores at
  epoch 5 (best by valid AUC, best by valid loss, last epoch) within 1e-5,
  the pooled AUC and ACC equal, and the folds derived on identical splits.
- the train CLI on the written directory gives run_experiment's result.
"""
import functools
import json
from pathlib import Path

import flax
import numpy as np
import pandas as pd
import pytest

from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.data import loaders as jloaders
from multilevel_gnn_tpu.train import driver as jdriver
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.data import loaders
from multilevel_gnn_tpu_torch.data.synthetic import write_reference_format
from multilevel_gnn_tpu_torch.interop import load_flax_params
from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
from multilevel_gnn_tpu_torch.train import cli
from multilevel_gnn_tpu_torch.train import driver

KW = dict(num_run=1, epochs=5, batch_size=8, node_embedding_dim=4, hidden_channels=8,
          final_channels=4, head_dim=16, conv_channel_list=[8, 16],
          feature_drop=False, head_drop_rate=0.0, gnn_dropout=0.0,
          compute_dtype=None, spmm_bf16=False, epoch_scan=False)
TOL = 1e-5
GBM = str(Path(__file__).resolve().parents[1] / "configs" / "gbm.yaml")


def _paths(d, ct="gbm"):
    return dict(
        mrna_path=f"{d}/{ct}/raw_mrna.csv", cnv_path=f"{d}/{ct}/raw_cnv.csv",
        methylation_path=f"{d}/{ct}/raw_methylation.csv",
        clinical_path=f"{d}/{ct}/clinical.pkl", kegg_path=f"{d}/kegg.csv",
        pathway_list_path=f"{d}/pathways.txt", edge_path=f"{d}/{ct}/grn_edges.tsv")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return build_setup(str(tmp_path_factory.mktemp("cohort")))


def build_setup(d):
    """The cohort written into d and loaded by both packages."""
    write_reference_format(d, seed=4, cancer_type="gbm", n_patients=60, n_pathways=5)
    mp = pytest.MonkeyPatch()
    mp.setattr(pd, "read_csv", functools.partial(pd.read_csv, float_precision="round_trip"))
    try:
        jcohort = jloaders.load_cohort_from_files(
            cfg=JConfig.from_yaml(GBM, **KW), **_paths(d))
    finally:
        mp.undo()
    cfg = Config.from_yaml(GBM, **KW)
    cohort = loaders.load_cohort_from_files(cfg=cfg, **_paths(d))
    return dict(dir=d, jcohort=jcohort, cohort=cohort, cfg=cfg)


class InitCarrier:
    """Records the JAX package's initial parameters of each fold (the params
    its run_fold hands to seed_pca_params) and builds the port's fold models
    from them, in the same order."""

    def __init__(self, monkeypatch):
        self.params = []
        real = jdriver.seed_pca_params

        def spy(params, seed):
            self.params.append({k: np.asarray(v) for k, v in
                                flax.traverse_util.flatten_dict(params, sep="/").items()})
            return real(params, seed)

        monkeypatch.setattr(jdriver, "seed_pca_params", spy)
        monkeypatch.setattr(driver, "_new_model", self.new_model)

    def new_model(self, cfg, ctx, seed):
        m = MultilevelGNN(cfg, ctx.graph.n_nodes, ctx.num_pca_rows, device=ctx.device)
        load_flax_params(m, self.params.pop(0))
        return m


def _spy_results(monkeypatch, module):
    out = []
    real = module.run_fold

    def spy(*a, **k):
        r = real(*a, **k)
        out.append(r)
        return r

    monkeypatch.setattr(module, "run_fold", spy)
    return out


def _close_scores(a, b):
    for key in ("epoch_pred", "epoch_pred_by_loss", "epoch_pred_by_epoch"):
        ea, eb = getattr(a, key), getattr(b, key)
        assert sorted(ea) == sorted(eb)
        for e in ea:
            np.testing.assert_allclose(ea[e], eb[e], rtol=0, atol=TOL)
    np.testing.assert_array_equal(a.y_true, b.y_true)


def test_run_fold_run1_fold2_matches_jax(setup, monkeypatch):
    jc, pc, cfg = setup["jcohort"], setup["cohort"], setup["cfg"]
    labels = pc.labels()
    np.testing.assert_array_equal(labels, jc.labels())
    tune, te = driver.stratified_kfold(labels, 5, cfg.split_shaffle, cfg.split_seed)[2]
    tr, va = driver.stratified_kfold(labels[tune], 5, cfg.split_shaffle, cfg.split_seed)[0]
    tr, va = tune[tr], tune[va]
    carrier = InitCarrier(monkeypatch)
    check = [1, 3, 5]
    jres = jdriver.run_fold(jc.cfg, jc, tr, va, te, 2, 1, check)
    pcfg, fold, X = driver.fold_setup(cfg, pc, tr, 2, device="cpu")
    pres = driver.run_fold(pcfg.replace(pathway_num=pc.n_pathways), fold.ctx, X, pc.Y,
                           pc.ages, tr, va, te, fold.class_weight, check,
                           run_i=1, fold_i=2)
    assert not carrier.params
    _close_scores(pres, jres)


def test_run_experiment_matches_jax(setup, monkeypatch):
    jc, pc, cfg = setup["jcohort"], setup["cohort"], setup["cfg"]
    carrier = InitCarrier(monkeypatch)
    jfolds = _spy_results(monkeypatch, jdriver)
    pfolds = _spy_results(monkeypatch, driver)
    jout = jdriver.run_experiment(jc.cfg, jc)
    pout = driver.run_experiment(cfg, pc, device="cpu")
    assert not carrier.params and len(jfolds) == len(pfolds) == 5
    for a, b in zip(pfolds, jfolds):
        _close_scores(a, b)
    assert pout["check_epochs"] == jout["check_epochs"] == [5]
    for key in ("auc", "auc_by_loss", "auc_by_epoch", "acc", "acc_by_loss", "acc_by_epoch"):
        assert pout[key] == jout[key], key
        assert pout[key + "_all"] == jout[key + "_all"]
        assert pout[key + "_std"] == jout[key + "_std"]
    assert [f["fold"] for f in pout["folds"]] == list(range(5))
    assert all(f["step_ms_median"] is None for f in pout["folds"])  # CPU: no CUDA events


def test_cli_runs_the_protocol(setup, tmp_path, capsys):
    out = tmp_path / "res.json"
    sets = [f"{k}={json.dumps(v)}" for k, v in KW.items() if k != "epoch_scan"]
    res = cli.main(["--config", GBM, "--data-dir", setup["dir"],
                    "--device", "cpu", "--out", str(out), "--set", *sets])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["pooled_auc"] == res["auc"][5]
    assert 0.0 <= line["pooled_auc"] <= 1.0 and np.isfinite(line["wall_time_s"])
    saved = json.loads(out.read_text())
    assert saved["config"]["epochs"] == 5 and len(saved["folds"]) == 5
