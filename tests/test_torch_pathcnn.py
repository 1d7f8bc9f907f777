"""PathCNN, the no-GNN baseline, in the port against the JAX package, on the
CPU (f32; the models' fixed dropouts off on both sides, torch_families.
no_dropout):

- the port's eval probabilities and image against JAX's (training mode,
  dropout off), the training loss, and the gradients of the
  training-mode forward's VJP at seeded cotangents, within 1e-5 x
  max(1, max|ref|): learnable PCA on the raw PCA-row values (kernel 3), the
  precomputed pathway attrs, and more_conv's three convs.  The BCE loss's
  own gradient is ill-conditioned at this head's saturated softmax
  (ROADMAP section 3, R6), so the parameter gradients are held through the
  VJP, head_0's weight at twice R6's reading (its age column carries the
  softmax's rounding times the age); the loss's gradient with respect to
  the probabilities is test_torch_train.py's;
- fold_setup's raw side channel equals JAX's for both forms;
- run_experiment, 1 run x 5 folds x 2 epochs on reference-format files:
  every fold's test scores within 1e-5, pooled AUC / ACC equal;
- pathcnn and vae_finetune through the train CLI with --ckpt-dir, then
  the predict CLI on fold 2's checkpoint: its scores equal the training
  run's last-epoch test scores; export raises TypeError (pathcnn) and
  ValueError (vae_finetune), explain likewise, the kinds JAX's fail with.
"""
import json

import jax
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.models import pathcnn as jpathcnn
from multilevel_gnn_tpu.train import driver as jdriver
from multilevel_gnn_tpu.train import step as jstep
from multilevel_gnn_tpu_torch.train import cli, driver, explain, export, predict
from multilevel_gnn_tpu_torch.train import step as pstep
from test_torch_experiment import GBM, KW, build_setup
from torch_families import (
    batches, check_grads, experiments_match, init_pair, no_dropout, pallas, port_cfg, rel_err,
    small_fold, vjp_pair)
from torch_threads import few_threads  # noqa: F401  (autouse)

CW = np.array([1.0, 1.7], np.float32)
# R6 (ROADMAP section 3): head_0.weight's VJP gradient read 6.9e-6
# (learnable), 1.83e-5 (more_conv); held at twice the larger
R6 = {"head_0.weight": 3.7e-5}
CASES = {
    "learnable": dict(learnable_pca=True, pathcnn_kernel_size=3),
    "attrs": dict(learnable_pca=False, pathcnn_kernel_size=3),
    "more_conv": dict(learnable_pca=True, more_conv=True, pathcnn_kernel_size=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pathcnn_eval_and_grads_match_jax(case, monkeypatch):
    no_dropout(monkeypatch, jpathcnn)
    jcfg = small_fold()["jcfg"].replace(model="pathcnn", pca_loss=True, pca_indep_loss=True,
                                        **CASES[case])
    f = small_fold()
    jb, pb = batches("raw" if jcfg.learnable_pca else "attr")
    jm = jpathcnn.PathCNN(jcfg)
    params, pm = init_pair(jm, jb)
    (jpred, jimg), jg = vjp_pair(jm, params, jb, pm, pb)
    check_grads(pm, jg, residue=R6)
    with pallas():
        jl, _ = jax.jit(jstep.make_loss_fn(jm, jcfg))(
            params, jb, f["jctx"], jax.numpy.asarray(CW), jax.random.PRNGKey(0))
    pm.eval()
    with torch.no_grad():
        ppred, pimg = pm(pb, f["pctx"])
        pm.train()
        pl, _ = pstep.make_loss_fn(port_cfg(jcfg))(pm, pb, f["pctx"], torch.from_numpy(CW),
                                                   torch.Generator().manual_seed(0))
    assert ppred.shape == (8, 2) and pimg.shape == (8, 1, 5, 6)
    assert rel_err(ppred.numpy(), jpred) <= 1e-5
    assert rel_err(pimg.numpy(), jimg) <= 1e-5
    assert abs(float(pl) - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return build_setup(str(tmp_path_factory.mktemp("cohort")))


@pytest.mark.parametrize("learnable", [True, False], ids=["learnable", "attrs"])
def test_fold_setup_raw_matches_jax(setup, learnable):
    jc, pc = setup["jcohort"], setup["cohort"]
    cfg = setup["cfg"].replace(model="pathcnn", learnable_pca=learnable)
    tr = driver.fold_indices(pc.labels(), cfg, 1)[0]
    _, _, _, jraw = jdriver.fold_setup(jc.cfg.replace(model="pathcnn", learnable_pca=learnable),
                                       jc, tr, 1)
    _, fold, _ = driver.fold_setup(cfg, pc, tr, 1, device="cpu")
    assert fold.raw.dtype == np.float32
    np.testing.assert_array_equal(fold.raw, jraw)


def test_pathcnn_protocol_matches_jax(setup, monkeypatch):
    no_dropout(monkeypatch, jpathcnn)
    kw = dict(model="pathcnn", learnable_pca=True, epochs=2, pca_loss=True)
    experiments_match(setup["jcohort"], setup["cohort"], setup["cfg"].replace(**kw),
                      monkeypatch, jcfg=setup["jcohort"].cfg.replace(**kw))


@pytest.mark.parametrize("model,refusal", [("pathcnn", TypeError), ("vae_finetune", ValueError)])
def test_predict_cli_on_a_checkpoint(setup, tmp_path, capsys, model, refusal):
    d = str(tmp_path / "ck")
    sets = [f"{k}={json.dumps(v)}" for k, v in {**KW, "epochs": 1, "model": model}.items()
            if k != "epoch_scan"]
    cli.main(["--config", GBM, "--data-dir", setup["dir"], "--device", "cpu",
              "--ckpt-dir", d, "--set", *sets])
    capsys.readouterr()
    out = predict.main(["--config", GBM, "--data-dir", setup["dir"], "--ckpt-dir", d,
                        "--fold", "2", "--device", "cpu", "--set", *sets])
    record = np.load(f"{d}/result_run0_fold2.npy", allow_pickle=True).item()
    np.testing.assert_array_equal(np.asarray(out["prob"], np.float32),
                                  record.epoch_pred_by_epoch[1])
    cfg = setup["cfg"].replace(epochs=1, model=model)
    st = predict.load_fold_state(cfg, setup["cohort"], d, 0, 2, device="cpu")
    batch = next(driver.iter_batches(st["X"], setup["cohort"].Y, setup["cohort"].ages,
                                     st["splits"]["test"], 8, "cpu", st["raw"]))
    with pytest.raises(refusal):
        export.export_program(st["model"], st["ctx"], 8, st["cfg"].node_num)
    with pytest.raises(refusal):
        explain.integrated_gradients(st["model"], batch, st["ctx"], steps=2)
