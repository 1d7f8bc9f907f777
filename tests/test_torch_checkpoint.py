"""The port's checkpoints, resume and scoring from a checkpoint, on the CPU.

- save / load / prune / latest_resumable_step: a model, its optimizer and
  a dropout generator round trip exactly (torch.load weights_only); the
  host state keeps the numpy RNG state; a bare step without its sidecar is
  not resumable; prune keeps the newest complete steps and sweeps an older
  bare one, deleting each sidecar with its tree.
- train -> save -> predict: run_fold with ckpt_dir, then predict_fold from
  the checkpoint, predict_fold with the model in memory and the predict
  CLI all give the in-memory evaluate's scores exactly.
- resume: run_experiment (gbm.yaml at small widths, bf16 trunk, gbm.yaml's
  dropouts, ckpt_every 1) interrupted by the interrupt_after hook in its
  second fold, then resumed through the train CLI's --ckpt-dir --resume,
  equals the uninterrupted run bit for bit: pooled AUC / ACC and every
  fold's test scores.
- explain CLI on the same checkpoints: one row per screened pathway, sorted
  by p, and the pathway scores of integrated gradients through the loaded
  model; explain_cohort's screen of one batch.
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.train import checkpoint as C
from multilevel_gnn_tpu_torch.train import cli, driver, explain, predict
from multilevel_gnn_tpu_torch.train.step import make_optimizer
from torch_threads import few_threads  # noqa: F401  (autouse)

GBM = str(Path(__file__).resolve().parents[1] / "configs" / "gbm.yaml")
SMALL = dict(node_embedding_dim=4, hidden_channels=8, final_channels=4, head_dim=16,
             conv_channel_list=[8, 16], ckpt_every=1)
SETS = [f"{k}={json.dumps(v)}" for k, v in SMALL.items()]


def test_save_load_prune_and_resumable_steps(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    cfg = Config(lr=1e-2)
    opt = make_optimizer(model, cfg, 2, name="adamw")
    gen = torch.Generator().manual_seed(7)
    d = str(tmp_path / "run0_fold0")
    rng = np.random.RandomState(3)
    for step in range(1, 5):
        model(torch.randn(4, 3)).sum().backward()
        opt.step()
        opt.zero_grad()
        torch.rand(5, generator=gen)
        rng.rand(3)
        C.save_checkpoint(d, model, opt, gen, {"epoch": step}, step=step)
        C.save_host_state(d, step, {"results": {"best": step}, "y_true_test": np.arange(3),
                                    "step_i": 10 * step, "np_rng_state": rng.get_state()})
    C.save_checkpoint(d, model, opt, gen, step=5)  # a kill before its sidecar
    os.makedirs(os.path.join(d, "step_0"))  # an older bare step
    assert C.latest_step(d) == 5 and C.latest_resumable_step(d) == 4
    tree, loop = C.load_checkpoint(d, 4)
    assert loop == {"epoch": 4} and tree["optimizer"]["count"] == 4
    m2 = torch.nn.Linear(3, 2)
    m2.load_state_dict(tree["model"])
    for a, b in zip(m2.parameters(), model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    g2 = torch.Generator()
    g2.set_state(tree["generator"])
    torch.testing.assert_close(torch.rand(5, generator=g2), torch.rand(5, generator=gen))
    host = C.load_host_state(d, 4)
    assert host["step_i"] == 40 and host["results"] == {"best": 4}
    r2 = np.random.RandomState(0)
    r2.set_state(host["np_rng_state"])
    np.testing.assert_array_equal(r2.rand(4), rng.rand(4))
    with pytest.raises(ValueError):
        C.save_host_state(d, 6, {"results": {}})
    C.prune_old_steps(d, keep=2)
    names = sorted(os.listdir(d))
    assert names == ["step_3", "step_3.host.npy", "step_3.loop.json", "step_4",
                     "step_4.host.npy", "step_4.loop.json", "step_5"], names
    assert C.latest_resumable_step(d) == 4
    assert C.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        C.load_checkpoint(str(tmp_path / "none"))


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    """The debug protocol of the train CLI (60 synthetic patients), run
    uninterrupted into a/ and interrupted, then resumed, into b/."""
    root = tmp_path_factory.mktemp("ckpt")
    cfg = Config.from_yaml(GBM, **SMALL).replace(num_run=1, epochs=5, batch_size=8)
    cohort = cli.make_cohort(cfg, True, None, True)
    a = driver.run_experiment(cfg, cohort, device="cpu", ckpt_dir=str(root / "a"))
    with pytest.raises(KeyboardInterrupt):
        driver.run_experiment(cfg, cohort, device="cpu", ckpt_dir=str(root / "b"),
                              interrupt_after=[7])
    interrupted = sorted(os.listdir(root / "b"))
    b = cli.main(["--config", GBM, "--synthetic", "--debug", "--device", "cpu",
                  "--ckpt-dir", str(root / "b"), "--resume", "--set", *SETS])
    return dict(root=root, cfg=cfg, cohort=cohort, a=a, b=b, interrupted=interrupted)


def test_resumed_experiment_equals_uninterrupted(protocol):
    a, b, root = protocol["a"], protocol["b"], protocol["root"]
    # fold 0 finished, fold 1 stopped after its second epoch
    assert protocol["interrupted"] == ["result_run0_fold0.npy", "run0_fold0", "run0_fold1"]
    assert [f.get("loaded", False) for f in b["folds"]] == [True] + [False] * 4
    for key in ("auc", "auc_by_loss", "auc_by_epoch", "acc", "acc_by_loss", "acc_by_epoch"):
        assert a[key] == b[key], key
    for f in range(5):
        fa = np.load(root / "a" / f"result_run0_fold{f}.npy", allow_pickle=True).item()
        fb = np.load(root / "b" / f"result_run0_fold{f}.npy", allow_pickle=True).item()
        np.testing.assert_array_equal(fa.y_true, fb.y_true)
        for attr in ("epoch_pred", "epoch_pred_by_loss", "epoch_pred_by_epoch"):
            for e, s in getattr(fa, attr).items():
                np.testing.assert_array_equal(s, getattr(fb, attr)[e])
    # the resumed fold ran its last three epochs here
    assert len(fb.epoch_times) == 5
    resumed = np.load(root / "b" / "result_run0_fold1.npy", allow_pickle=True).item()
    assert len(resumed.epoch_times) == 3


def test_predict_fold_from_checkpoint_equals_evaluate(protocol, tmp_path, capsys):
    cfg, cohort = protocol["cfg"], protocol["cohort"]
    labels = cohort.labels()
    tr, va, te = driver.fold_indices(labels, cfg, 3)
    fcfg, fold, X = driver.fold_setup(cfg, cohort, tr, 3, device="cpu")
    fcfg = fcfg.replace(pathway_num=cohort.n_pathways, epochs=2)
    model = driver._new_model(fcfg, fold.ctx, 5)
    d = str(tmp_path)
    driver.run_fold(fcfg, fold.ctx, X, cohort.Y, cohort.ages, tr, va, te,
                    fold.class_weight, [2], model=model, run_i=1, fold_i=3, ckpt_dir=d)
    auc, acc, y_true, score, loss = driver.evaluate(
        model, fold.ctx, X, cohort.Y, cohort.ages, te, fcfg.batch_size)
    for res in (predict.predict_fold(cfg, cohort, d, 1, 3, device="cpu"),
                predict.predict_fold(cfg, cohort, None, 1, 3, model=model, device="cpu")):
        np.testing.assert_array_equal(res["prob"], score.astype(np.float64))
        assert (res["auc"], res["acc"], res["loss"]) == (auc, acc, loss)
        assert res["patients"] == [cohort.patients[i] for i in te]
    out = tmp_path / "p.json"
    res = predict.main(["--config", GBM, "--ckpt-dir", d, "--run", "1", "--fold", "3",
                        "--synthetic", "--debug", "--device", "cpu", "--out", str(out),
                        "--set", *SETS])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["auc"] == auc and line["split"] == "test"
    assert json.loads(out.read_text())["prob"] == res["prob"] == [float(s) for s in score]


def test_explain_cli_reads_the_checkpoint(protocol, tmp_path, capsys):
    root, cfg, cohort = protocol["root"], protocol["cfg"], protocol["cohort"]
    out = tmp_path / "rows.json"
    res = explain.main(["--config", GBM, "--ckpt-dir", str(root / "a"), "--fold", "2",
                        "--synthetic", "--debug", "--device", "cpu", "--ig-steps", "4",
                        "--top", "3", "--out", str(out), "--set", *SETS])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows = json.loads(out.read_text())
    assert rows == res["rows"] and line["top_pathways"] == rows[:3] and rows
    assert [r["p"] for r in rows] == sorted(r["p"] for r in rows)
    assert {r["pathway"] for r in rows} <= set(cohort.used_pathways)
    st = predict.load_fold_state(cfg, cohort, str(root / "a"), 0, 2, device="cpu")
    te = st["splits"]["test"]
    assert line["patients"] == len(te) == res["scores"].shape[0]
    # the first chunk by hand: IG through the checkpoint's model
    from multilevel_gnn_tpu_torch.core.batch import Batch

    part = te[: cfg.batch_size]
    batch = Batch(x=torch.as_tensor(st["X"][part]), y=torch.as_tensor(cohort.Y[part]),
                  age=torch.as_tensor(cohort.ages[part]),
                  sample_mask=torch.ones(len(part), dtype=torch.bool))
    ig = explain.integrated_gradients(st["model"], batch, st["ctx"], steps=4)
    want = explain.pathway_attributions(ig, st["ctx"], cohort.n_pathways)
    np.testing.assert_array_equal(res["scores"][: len(part)], want)
    # explain_cohort: the same batch's screen
    pats = [cohort.patients[i] for i in part]
    assert explain.explain_cohort(st["model"], cohort, st["ctx"], batch, 4, part) == (
        explain.pathway_km_screen(want, np.array([cohort.survive_time[p] for p in pats]),
                                  np.array([cohort.survive_state[p] for p in pats]),
                                  cohort.used_pathways))
