"""DeeperGCN's gene-level fold and CV protocol in the PyTorch port against
the JAX package's, on the CPU.

A tiny cohort (60 patients, 5 pathways) is written by the port's
write_reference_format and loaded by both packages' load_cohort_from_files
under gbm.yaml with model=deepergcn at small widths (f32, dropout off).

- gene_level_features (with mul_attr too), gene_level_graph (with
  bi_global_node too) and pathway_edge_num: equal; deepergcn_fold's graph
  (senders, receivers, attrs, mask), its MI mask and pathway_node_attr,
  and the port's edge ids (JAX's clipped int ids): equal.
- run_experiment, 1 run x 5 folds x 2 epochs, each fold's initial
  parameters JAX's (after its apply_init_weight), carried into the port by
  replacing driver._new_model, the pooled AUC and ACC equal: with
  gcn_aggr softmax every fold's test scores within 1e-5; with the slice's
  gcn_aggr max within MAX_TIE_RESIDUE (ROADMAP section 3).  The max's
  backward sends the whole cotangent to every tied edge, and relu(.) + eps
  makes many messages tie at eps: a pre-activation that f32 sums in
  another order (XLA's and torch's GEMMs) leave just above 0 on one side
  breaks a tie there, so that side's gradient moves to one edge, and
  Adam's first step moves the entries it touches by lr with opposite
  signs (node_embedding, 2e-4 apart after step 1 of fold 0).  With every
  relu a leaky relu on both sides (no tie at eps) the max protocol's
  largest deviation falls to 3.7e-5 (NO_TIE_RESIDUE).
- the train CLI with --ckpt-dir, then the predict CLI on fold 2's
  checkpoint: its test probabilities equal the fold's last-epoch test
  scores and predict_fold's; integrated gradients run on a batch, and, as
  in JAX, pathway_attributions and the explain CLI raise IndexError and
  export_program raises ValueError (test_torch_deepergcn_workflows.py
  holds these against JAX).
"""
import json
from pathlib import Path

import flax
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.data import loaders as jloaders
from multilevel_gnn_tpu.train import driver as jdriver
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.data import loaders
from multilevel_gnn_tpu_torch.data.synthetic import write_reference_format
from multilevel_gnn_tpu_torch.interop import load_flax_params
from multilevel_gnn_tpu_torch.models.deepergcn import DeeperGCN
from multilevel_gnn_tpu_torch.train import cli, driver, explain, export, predict
from torch_threads import few_threads  # noqa: F401  (autouse)

GBM = str(Path(__file__).resolve().parents[1] / "configs" / "gbm.yaml")
KW = dict(model="deepergcn", num_run=1, epochs=2, batch_size=8, hidden_channels=8,
          num_layers=2, node_embedding_dim=4, dropout=0.0, feature_drop=False,
          compute_dtype=None, spmm_bf16=False, epoch_scan=False)
TOL = 1e-5
# fold test scores with gcn_aggr max: twice the reading (1.43e-4, fold 0,
# best-by-epoch scores, tests/torch_deepergcn_report.py)
MAX_TIE_RESIDUE = 2.9e-4
# the same with every relu a leaky relu on both sides, no tie at eps: twice
# the reading (3.7e-5, fold 0; ROADMAP section 3, R2)
NO_TIE_RESIDUE = 7.4e-5


def _paths(d):
    return dict(
        mrna_path=f"{d}/gbm/raw_mrna.csv", cnv_path=f"{d}/gbm/raw_cnv.csv",
        methylation_path=f"{d}/gbm/raw_methylation.csv",
        clinical_path=f"{d}/gbm/clinical.pkl", kegg_path=f"{d}/kegg.csv",
        pathway_list_path=f"{d}/pathways.txt", edge_path=f"{d}/gbm/grn_edges.tsv")


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cohort"))
    write_reference_format(d, seed=4, cancer_type="gbm", n_patients=60, n_pathways=5)
    return d


def _load(d, **kw):
    kw = {**KW, **kw}
    jc = jloaders.load_cohort_from_files(cfg=JConfig.from_yaml(GBM, **kw), **_paths(d))
    cfg = Config.from_yaml(GBM, **kw)
    return jc, loaders.load_cohort_from_files(cfg=cfg, **_paths(d)), cfg


@pytest.fixture(scope="module")
def both(written):
    return _load(written)


def test_gene_level_graph_and_fold_equal_jax(both):
    jc, pc, cfg = both
    np.testing.assert_array_equal(pc.gene_level_features(), jc.gene_level_features())
    jei, jea = jc.gene_level_graph()
    pei, pea = pc.gene_level_graph()
    np.testing.assert_array_equal(pei, jei)
    np.testing.assert_array_equal(pea, jea)
    assert pc.pathway_edge_num == jc.pathway_edge_num > 0
    assert (pea[: len(pea) - pc.pathway_edge_num, 1] == np.floor(
        pea[: len(pea) - pc.pathway_edge_num, 0])).all()  # int(weight) ids
    tr = driver.fold_indices(pc.labels(), cfg, 1)[0]
    jf = jc.deepergcn_fold(tr, 1)
    pf = pc.deepergcn_fold(tr, 1, device="cpu")
    jg, pg = jf.ctx.graph, pf.ctx.graph
    for name in ("senders", "receivers", "edge_attr", "edge_mask"):
        np.testing.assert_array_equal(getattr(pg, name).numpy(), np.asarray(getattr(jg, name)))
    assert pg.n_nodes == jg.n_nodes and pf.edge_count == jf.edge_count
    np.testing.assert_array_equal(pf.info_mask, jf.info_mask)
    np.testing.assert_array_equal(pf.pathway_node_attr, jf.pathway_node_attr)
    V = max(jc.pathway_edge_num, 1)
    want = np.clip(np.asarray(jg.edge_attr)[:, -1].astype(np.int32), 0, V - 1)
    np.testing.assert_array_equal(pf.ctx.edge_ids.numpy(), want)
    assert pf.ctx.edge_id_gather.n_rows == V
    fcfg, fold, X = driver.fold_setup(cfg, pc, tr, 1, device="cpu")
    assert fcfg.node_num == pc.node_size + pc.n_pathways and fcfg.pathway_edge_num == V
    assert X.shape == (len(pc.patients), fcfg.node_num, 3)
    assert fold.raw.dtype == np.float32 and fold.raw.shape[1:] == (pc.n_pathways, 6)


def test_bi_global_node_and_mul_attr_equal_jax(written):
    jc, pc, _ = _load(written, bi_global_node=True, mul_attr=True)
    np.testing.assert_array_equal(pc.gene_level_features(), jc.gene_level_features())
    assert pc.gene_level_features().shape[-1] == 5
    for a, b in zip(pc.gene_level_graph(), jc.gene_level_graph()):
        np.testing.assert_array_equal(a, b)
    assert pc.pathway_edge_num == jc.pathway_edge_num


class InitCarrier:
    """JAX's initial parameters of each fold (where its run_fold hands them
    to seed_pca_params, after apply_init_weight) as the port's fold models,
    in order."""

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
        m = DeeperGCN(cfg, device=ctx.device)
        load_flax_params(m, self.params.pop(0))
        return m


def _spy_results(monkeypatch, module):
    out, real = [], module.run_fold

    def spy(*a, **k):
        out.append(real(*a, **k))
        return out[-1]

    monkeypatch.setattr(module, "run_fold", spy)
    return out


@pytest.mark.parametrize("aggr", ["softmax", "max"])
def test_run_experiment_matches_jax(written, aggr, monkeypatch):
    jc, pc, cfg = _load(written, gcn_aggr=aggr)
    tol = TOL if aggr == "softmax" else MAX_TIE_RESIDUE
    carrier = InitCarrier(monkeypatch)
    jfolds = _spy_results(monkeypatch, jdriver)
    pfolds = _spy_results(monkeypatch, driver)
    jout = jdriver.run_experiment(jc.cfg, jc)
    pout = driver.run_experiment(cfg, pc, device="cpu")
    assert not carrier.params and len(jfolds) == len(pfolds) == 5
    for a, b in zip(pfolds, jfolds):
        for key in ("epoch_pred", "epoch_pred_by_loss", "epoch_pred_by_epoch"):
            for e in getattr(b, key):
                np.testing.assert_allclose(getattr(a, key)[e], getattr(b, key)[e],
                                           rtol=0, atol=tol)
        np.testing.assert_array_equal(a.y_true, b.y_true)
    assert pout["check_epochs"] == jout["check_epochs"] == [2]
    for key in ("auc", "auc_by_loss", "auc_by_epoch", "acc", "acc_by_loss", "acc_by_epoch"):
        assert pout[key] == jout[key], key


def test_run_experiment_max_without_ties_matches_jax(written, monkeypatch):
    """R2's witness: the max protocol of test_run_experiment_matches_jax with
    every relu a leaky relu (slope 0.01) on both sides, so that no two
    messages tie at eps: the largest fold deviation falls from 1.43e-4 to
    3.7e-5 (held at NO_TIE_RESIDUE), pooled AUC and ACC equal."""
    import jax
    import torch
    import torch.nn.functional as F

    relu = jax.nn.relu
    monkeypatch.setattr(jax.nn, "relu", lambda x: jax.nn.leaky_relu(x, 0.01))
    monkeypatch.setattr(torch, "relu", lambda x: F.leaky_relu(x, 0.01))
    monkeypatch.setattr(F, "relu", lambda x: F.leaky_relu(x, 0.01))
    monkeypatch.setattr(jdriver, "_FNS_CACHE", {})
    jax.clear_caches()
    try:
        assert float(jax.nn.relu(-1.0)) == float(np.float32(-0.01)) and relu is not jax.nn.relu
        jc, pc, cfg = _load(written, gcn_aggr="max")
        InitCarrier(monkeypatch)
        jfolds = _spy_results(monkeypatch, jdriver)
        pfolds = _spy_results(monkeypatch, driver)
        jout = jdriver.run_experiment(jc.cfg, jc)
        pout = driver.run_experiment(cfg, pc, device="cpu")
    finally:
        jax.clear_caches()
    for a, b in zip(pfolds, jfolds):
        for key in ("epoch_pred", "epoch_pred_by_loss", "epoch_pred_by_epoch"):
            for e in getattr(b, key):
                np.testing.assert_allclose(getattr(a, key)[e], getattr(b, key)[e],
                                           rtol=0, atol=NO_TIE_RESIDUE)
    for key in ("auc", "acc"):
        assert pout[key] == jout[key], key


def test_cli_then_predict_cli_on_a_deepergcn_checkpoint(written, both, tmp_path, capsys):
    _, pc, cfg = both
    d = str(tmp_path / "ck")
    sets = [f"{k}={json.dumps(v)}" for k, v in KW.items() if k != "epoch_scan"]
    res = cli.main(["--config", GBM, "--data-dir", written, "--device", "cpu",
                    "--ckpt-dir", d, "--set", *sets])
    assert len(res["folds"]) == 5 and 0.0 <= res["auc"][2] <= 1.0
    capsys.readouterr()
    out = predict.main(["--config", GBM, "--data-dir", written, "--ckpt-dir", d,
                        "--fold", "2", "--device", "cpu", "--set", *sets])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    record = np.load(f"{d}/result_run0_fold2.npy", allow_pickle=True).item()
    np.testing.assert_array_equal(np.asarray(out["prob"], np.float32),
                                  record.epoch_pred_by_epoch[2])
    mem = predict.predict_fold(cfg, pc, d, 0, 2, device="cpu")
    assert mem["prob"] == out["prob"] and line["auc"] == mem["auc"]
    st = predict.load_fold_state(cfg, pc, d, 0, 2, device="cpu")
    batch = next(driver.iter_batches(st["X"], pc.Y, pc.ages, st["splits"]["test"],
                                     8, "cpu", st["raw"]))
    ig = explain.integrated_gradients(st["model"], batch, st["ctx"], steps=2)
    assert ig.shape == batch.x.shape and torch.isfinite(ig).all()
    # as in JAX: the PCA-row mapping indexes the 3-slot node space
    with pytest.raises(IndexError):
        explain.pathway_attributions(ig, st["ctx"], pc.n_pathways)
    with pytest.raises(IndexError):
        explain.main(["--config", GBM, "--data-dir", written, "--ckpt-dir", d, "--fold", "2",
                      "--ig-steps", "2", "--device", "cpu", "--set", *sets])
    # as in JAX: a (B, NODES) x meets the model's 3-D unpacking
    with pytest.raises(ValueError, match="not enough values to unpack"):
        export.export_program(st["model"], st["ctx"], 8, st["cfg"].node_num)
