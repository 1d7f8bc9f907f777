"""The port's fold-parallel CV (train/fold_parallel.py) on the CPU.

Against the port's sequential run_experiment, with gbm.yaml's dropouts on
(feature_drop 0.25, head dropout 0.5, and its rate 0.25 as the SAGE MLP's
gnn_dropout) and an f32
trunk, on a 50-patient synthetic cohort: each unit draws its masks from
its own generator, so the pooled scores must agree.  The cases mirror the
JAX package's tests/test_fold_parallel.py: matches sequential, devices=5
(five CPU groups) against one group, two runs (10 units), weighted loss
(ceil(n / bs) batches with a ragged masked one), zero train batches,
checkpoint -> interrupt -> resume equal to the uninterrupted run with the
checkpoints read by predict_fold, and both of JAX's arms.

Against the JAX package's run_experiment_foldparallel with dropout and the
feature drops off (the RNG streams cannot match across frameworks), on the
reference-format cohort of test_torch_experiment.py, each unit starting
from JAX's initial parameters: JAX's per-step arm (epoch_scan off) and its
one-dispatch arm (epoch_scan, fold_scan on).

The model options that change the stacked step (merge's second graph,
gat, mr, pca_lowrank, dense_gnn, the clip with StepLR and warmup, the
bf16 trunk) against the sequential protocol too.

Also: the first stacked step's per-unit gradients against each unit's own
train step; the pathway contraction's dense route under vmap, counted once
a stacked step (``pathway.dense_vmap``) and never in a unit's own step; the ragged-trim warning; the ValueError on folds that do not
stack (one composed among windowed); and the CLI's --fold-parallel (no value parses to 0, --pretrain exits 2,
the protocol's JSON line).

Tolerances: pooled AUC, AUC by loss, AUC by epoch and ACC within rtol
1e-5, atol 1e-6 (JAX's own, tests/test_fold_parallel.py:_check); devices=5
and the resume against one uninterrupted group within rtol 1e-6, as
JAX's; each parameter's gradient within 1e-5 of its largest element.
"""
import copy
import dataclasses
import json
import logging
from pathlib import Path

import flax
import numpy as np
import pytest
import torch

import multilevel_gnn_tpu.models.multilevel_gnn as jmlg
from multilevel_gnn_tpu.train import fold_parallel as jfp
from multilevel_gnn_tpu_torch.core.batch import Batch
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.data.synthetic import make_synthetic_cohort
from multilevel_gnn_tpu_torch.interop import load_flax_params
from multilevel_gnn_tpu_torch.models import get_model
from multilevel_gnn_tpu_torch.nn.basic import UnitGenerators
from multilevel_gnn_tpu_torch.train import cli, driver
from multilevel_gnn_tpu_torch.train import fold_parallel as fp
from multilevel_gnn_tpu_torch.train import step as S
from multilevel_gnn_tpu_torch.train.predict import predict_fold

from test_torch_experiment import KW as JAX_KW
from test_torch_experiment import build_setup
from torch_threads import few_threads  # noqa: F401  (autouse)

GBM = str(Path(__file__).resolve().parents[1] / "configs" / "gbm.yaml")
TINY = dict(epochs=2, num_run=1, batch_size=8, split_shaffle=True, split_seed=3,
            node_embedding_dim=4, hidden_channels=8, final_channels=4, head_dim=16,
            conv_channel_list=[8, 16], compute_dtype=None, spmm_bf16=False,
            gnn_dropout=0.25)


def _cfg(**kw):
    return Config.from_yaml(GBM, **{**TINY, **kw})


def _cohort(cfg):
    return make_synthetic_cohort(cfg, seed=0, n_patients=50, n_pathways=5)


def _check(seq, par, rtol=1e-5, atol=1e-6):
    e = seq["check_epochs"][-1]
    assert par["check_epochs"] == seq["check_epochs"]
    for key in ("auc", "auc_by_loss", "auc_by_epoch", "acc"):
        np.testing.assert_allclose(par[key][e], seq[key][e], rtol=rtol, atol=atol,
                                   err_msg=key)


def test_dropout_is_on():
    """gbm.yaml's dropouts (feature_drop 0.25, head_drop_rate 0.5), and its
    dropout rate 0.25 in the SAGE MLP too (gnn_dropout)."""
    cfg = _cfg()
    assert cfg.dropout == 0.25 and cfg.feature_drop and cfg.head_drop_rate == 0.5
    assert cfg.gnn_dropout == 0.25


def test_foldparallel_matches_sequential():
    cfg = _cfg()
    cohort = _cohort(cfg)
    seq = driver.run_experiment(cfg, cohort, device="cpu")
    par = fp.run_experiment_foldparallel(cfg, cohort, device="cpu")
    assert par["units"] == 5 and par["arm"] == "per-step" and par["devices"] == 1
    assert par["step_ms_median"] is None  # CPU: no CUDA events
    _check(seq, par)
    for k in ("auc_std", "auc_all", "acc_by_loss", "acc_by_epoch", "epoch_s_median",
              "wall_time_s"):
        assert k in par


@pytest.mark.parametrize("kw", [
    dict(edge_type="merge"), dict(gnn_name="gat", final_head=4), dict(gnn_name="mr"),
    dict(reduction_method="pca_lowrank"), dict(dense_gnn=True),
    dict(clip_grad=True, step=1, gamma=0.5, warmup_epochs=1),
    dict(compute_dtype="bfloat16", spmm_bf16=True),
], ids=["merge", "gat", "mr", "pca_lowrank", "dense_gnn", "clip_steplr_warmup", "bf16"])
def test_foldparallel_options_match_sequential(kw):
    """The stacked step with a second graph, GAT's f32 edge softmax, K3's
    max, the runtime PCA (one start block for every unit), dense_gnn, the
    per-unit clip with StepLR and warmup, and the bf16 trunk."""
    cfg = _cfg(**kw)
    cohort = _cohort(cfg)
    if "reduction_method" in kw:
        cfg = cfg.replace(slot_sizes=cohort.slot_sizes())
    _check(driver.run_experiment(cfg, cohort, device="cpu"),
           fp.run_experiment_foldparallel(cfg, cohort, device="cpu"))


def test_foldparallel_devices_five_cpu_groups():
    """The units in five groups of one (devices=5) == one group of five."""
    cfg = _cfg()
    cohort = _cohort(cfg)
    one = fp.run_experiment_foldparallel(cfg, cohort, device="cpu")
    five = fp.run_experiment_foldparallel(cfg, cohort, devices=5, device="cpu")
    assert five["devices"] == 5
    _check(one, five, rtol=1e-6, atol=0)
    with pytest.raises(AssertionError):
        fp.run_experiment_foldparallel(cfg, cohort, devices=3, device="cpu")


def test_foldparallel_multi_run():
    """2 runs x 5 folds = 10 lockstep units; run-level pooled stats match."""
    cfg = _cfg(num_run=2)
    cohort = _cohort(cfg)
    seq = driver.run_experiment(cfg, cohort, device="cpu")
    par = fp.run_experiment_foldparallel(cfg, cohort, device="cpu")
    assert par["units"] == 10
    _check(seq, par)
    np.testing.assert_allclose(par["auc_all"][2], seq["auc_all"][2], rtol=1e-5, atol=1e-6)


def test_foldparallel_weighted_loss_matches_sequential():
    """weighted_loss turns drop_last off: ceil(n / bs) batches an epoch,
    the last one ragged and masked, in both drivers."""
    cfg = _cfg(weighted_loss=True, batch_size=6)
    cohort = _cohort(cfg)
    _check(driver.run_experiment(cfg, cohort, device="cpu"),
           fp.run_experiment_foldparallel(cfg, cohort, device="cpu"))


def test_foldparallel_zero_train_batches():
    """batch_size above the train split: no train step, as sequentially."""
    cfg = _cfg(batch_size=64, epochs=1)
    cohort = _cohort(cfg)
    _check(driver.run_experiment(cfg, cohort, device="cpu"),
           fp.run_experiment_foldparallel(cfg, cohort, device="cpu"))


def test_foldparallel_checkpoint_resume_and_predict(tmp_path):
    cfg = _cfg(epochs=4, ckpt_every=1)
    cohort = _cohort(cfg)
    full = fp.run_experiment_foldparallel(cfg, cohort, ckpt_dir=str(tmp_path / "a"),
                                          device="cpu")
    fp.run_experiment_foldparallel(cfg.replace(epochs=2), cohort,
                                   ckpt_dir=str(tmp_path / "b"), device="cpu")
    resumed = fp.run_experiment_foldparallel(cfg, cohort, ckpt_dir=str(tmp_path / "b"),
                                             resume=True, device="cpu")
    _check(full, resumed, rtol=1e-6, atol=0)
    assert len(resumed["check_epochs"]) == 1 and resumed["units"] == 5
    # the per-unit checkpoints are run_fold's layout: predict reads them
    res = predict_fold(cfg, cohort, str(tmp_path / "a"), run_i=0, fold_i=1,
                       split="test", device="cpu")
    assert len(res["prob"]) > 0 and 0.0 <= res["auc"] <= 1.0
    # and each unit's parameters there are the ones its sequential run_fold
    # would have saved: fold 1 trained alone for 4 epochs, checkpointed
    seq_dir = tmp_path / "seq"
    labels = cohort.labels()
    tr, va, te = driver.fold_indices(labels, cfg, 1)
    fcfg, fold, X = driver.fold_setup(cfg, cohort, tr, 1, device="cpu")
    driver.run_fold(fcfg.replace(pathway_num=cohort.n_pathways), fold.ctx, X, cohort.Y,
                    cohort.ages, tr, va, te, fold.class_weight, [4], run_i=0, fold_i=1,
                    ckpt_dir=str(seq_dir))
    from multilevel_gnn_tpu_torch.train import checkpoint as C

    a, _ = C.load_checkpoint(str(tmp_path / "a" / "run0_fold1"), 4)
    b, _ = C.load_checkpoint(str(seq_dir / "run0_fold1"), 4)
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        ref = b["model"][k]
        assert float((a["model"][k] - ref).abs().max()) <= 1e-5 * max(
            float(ref.abs().max()), 1e-30), k
    assert a["optimizer"]["count"] == b["optimizer"]["count"]
    assert torch.equal(a["generator"], b["generator"])


class _JaxInit:
    """JAX's fold-parallel initial parameters of each unit (what it hands to
    seed_pca_params), carried into the port's units in the same order."""

    def __init__(self, monkeypatch):
        self.params = []
        real = jmlg.seed_pca_params

        def spy(params, seed):
            self.params.append({k: np.asarray(v) for k, v in
                                flax.traverse_util.flatten_dict(params, sep="/").items()})
            return real(params, seed)

        monkeypatch.setattr(jmlg, "seed_pca_params", spy)
        monkeypatch.setattr(driver, "_new_model", self.new_model)

    def new_model(self, cfg, ctx, seed, init_weight=True):
        m = get_model(cfg.model)(cfg, ctx.graph.n_nodes, ctx.num_pca_rows, device=ctx.device)
        load_flax_params(m, self.params.pop(0))
        return m


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return build_setup(str(tmp_path_factory.mktemp("fp_cohort")))


@pytest.mark.parametrize("arm", ["per-step", "one-dispatch"])
def test_foldparallel_matches_jax_both_arms(files, monkeypatch, arm):
    jc, pc, cfg = files["jcohort"], files["cohort"], files["cfg"]
    assert not (cfg.feature_drop or cfg.gnn_dropout or cfg.head_drop_rate)
    assert cfg.compute_dtype is None and not cfg.spmm_bf16 and JAX_KW["epoch_scan"] is False
    carrier = _JaxInit(monkeypatch)
    jcfg = jc.cfg if arm == "per-step" else jc.cfg.replace(epoch_scan=True, fold_scan=True)
    jout = jfp.run_experiment_foldparallel(jcfg, jc)
    assert jout["arm"] == arm and len(carrier.params) == 5
    pout = fp.run_experiment_foldparallel(cfg, pc, device="cpu")
    assert not carrier.params
    assert pout["units"] == jout["units"] == 5
    _check(jout, pout)


def _step_setup(cfg, cohort, units):
    """The stacked state of ``units`` ((run, fold) pairs) and each unit's
    own model, optimizer, generator and first batch."""
    labels = cohort.labels()
    out = []
    for run_i, fold_i in units:
        tr, va, te = driver.fold_indices(labels, cfg, fold_i)
        fcfg, fold, X = driver.fold_setup(cfg, cohort, tr, fold_i, device="cpu")
        fcfg = fcfg.replace(pathway_num=cohort.n_pathways)
        seed = cfg.seed * 10_000 + run_i * 100 + fold_i
        model = driver._new_model(fcfg, fold.ctx, seed)
        driver.seed_pca_params(model, fold.ctx.pca_seed)
        take, mask, _ = next(driver.epoch_plan(X, tr, cfg.batch_size,
                                               np.random.RandomState(seed), True, True))
        batch = Batch(x=torch.from_numpy(np.asarray(X[take], np.float32)),
                      y=torch.from_numpy(np.asarray(cohort.Y[take], np.float32)),
                      age=torch.from_numpy(np.asarray(cohort.ages[take], np.float32)),
                      sample_mask=torch.from_numpy(mask))
        out.append(dict(cfg=fcfg, ctx=fold.ctx, model=model, batch=batch, seed=seed,
                        cw=torch.tensor(fold.class_weight, dtype=torch.float32)))
    return out


def test_first_stacked_step_gradients_match_units():
    cfg = _cfg(clip_grad=True)
    cohort = _cohort(cfg)
    units = _step_setup(cfg, cohort, [(0, f) for f in range(5)])
    from multilevel_gnn_tpu_torch.core.batch import stack_contexts

    sctx = stack_contexts([u["ctx"] for u in units])
    params = S.stack_params([u["model"] for u in units])
    template = copy.deepcopy(units[0]["model"])
    fcfg = units[0]["cfg"]
    opt = S.Optimizer(list(params.values()), fcfg, 4, units=5)
    gens = UnitGenerators(torch.Generator().manual_seed(u["seed"]) for u in units)
    batch = Batch(*(torch.stack([getattr(u["batch"], f) for u in units])
                    for f in ("x", "y", "age", "sample_mask")))
    cw = torch.stack([u["cw"] for u in units])
    # the stacked step's gradients, before the update
    step = opt.step
    opt.step = lambda: None
    losses = S.stacked_train_step(template, params, opt, batch, sctx, cw, gens)
    grads = {k: p.grad.clone() for k, p in params.items()}
    opt.step = step
    for i, u in enumerate(units):
        m = u["model"]
        m.train()
        m.zero_grad()
        loss, _ = S.make_loss_fn(fcfg)(m, u["batch"], u["ctx"], u["cw"],
                                       torch.Generator().manual_seed(u["seed"]))
        loss.backward()
        assert abs(float(loss.detach()) - float(losses[i])) <= 1e-5 * abs(float(losses[i]))
        for k, p in m.named_parameters():
            ref = p.grad if p.grad is not None else torch.zeros_like(p)
            err = float((grads[k][i] - ref).abs().max())
            assert err <= 1e-5 * float(ref.abs().max()), (i, k, err)


def test_stacked_step_counts_the_dense_pathway_route():
    """Under torch.vmap the pathway contraction takes its dense route over
    each unit's own slot ids and counts it, once a stacked step; a unit's
    own step takes its fold's slot plan and counts nothing."""
    from multilevel_gnn_tpu_torch.core.batch import stack_contexts
    from multilevel_gnn_tpu_torch.utils.profiling import recording

    cfg = _cfg()
    cohort = _cohort(cfg)
    units = _step_setup(cfg, cohort, [(0, 0), (0, 1)])
    sctx = stack_contexts([u["ctx"] for u in units])
    params = S.stack_params([u["model"] for u in units])
    fcfg = units[0]["cfg"]
    opt = S.Optimizer(list(params.values()), fcfg, 4, units=2)
    gens = UnitGenerators(torch.Generator().manual_seed(u["seed"]) for u in units)
    batch = Batch(*(torch.stack([getattr(u["batch"], f) for u in units])
                    for f in ("x", "y", "age", "sample_mask")))
    cw = torch.stack([u["cw"] for u in units])
    with recording() as rec:
        S.stacked_train_step(copy.deepcopy(units[0]["model"]), params, opt, batch, sctx,
                             cw, gens)
    assert rec.counts.get("pathway.dense_vmap") == 1, rec.counts
    u = units[0]
    with recording() as rec:
        loss, _ = S.make_loss_fn(fcfg)(u["model"], u["batch"], u["ctx"], u["cw"],
                                       torch.Generator().manual_seed(u["seed"]))
        loss.backward()
    assert "pathway.dense_vmap" not in rec.counts, rec.counts


def _ragged_cfg():
    """weighted_loss (ceil(n / bs) batches an epoch) at a batch size under
    which the five train splits of a 52-patient cohort give unequal
    counts."""
    cfg = _cfg(epochs=1, weighted_loss=True)
    cohort = make_synthetic_cohort(cfg, seed=0, n_patients=52, n_pathways=5)
    labels = cohort.labels()
    n = [len(driver.fold_indices(labels, cfg, f)[0]) for f in range(5)]
    for bs in range(4, 17):
        if len({-(-k // bs) for k in n}) > 1:
            return cfg.replace(batch_size=bs), cohort
    raise AssertionError(f"no ragged batch size for train splits {n}")


def test_ragged_train_batches_trim_with_warning(caplog):
    cfg, cohort = _ragged_cfg()
    with caplog.at_level(logging.WARNING, logger="mgtpu.fold_parallel"):
        out = fp.run_experiment_foldparallel(cfg, cohort, device="cpu")
    assert any("ragged train batches" in r.getMessage() for r in caplog.records)
    assert np.isfinite(out["auc"][1]) and out["units"] == 5


def test_folds_that_do_not_stack_raise(monkeypatch):
    """One fold composed among windowed ones (as windowed_min_edges would
    split them): ValueError naming that unit."""
    cfg = _cfg(windowed_spmm=True, windowed_min_edges=0)
    cohort = _cohort(cfg)
    real = fp.fold_setup

    def setup(c, coh, train_idx, fold_i, device):
        c2, fold, X = real(c, coh, train_idx, fold_i, device)
        assert fold.ctx.graph.winplan is not None
        if fold_i == 3:
            g = dataclasses.replace(fold.ctx.graph, winplan=None)
            fold = dataclasses.replace(fold, ctx=dataclasses.replace(fold.ctx, graph=g))
        return c2, fold, X

    monkeypatch.setattr(fp, "fold_setup", setup)
    with pytest.raises(ValueError, match="run 0 fold 3"):
        fp.run_experiment_foldparallel(cfg, cohort, device="cpu")


def test_recommended_arm():
    assert fp.recommended_arm(1) == "sequential"
    assert fp.recommended_arm(4) == "fold_parallel"


def test_cli_fold_parallel_flag(capsys, monkeypatch):
    seen = {}
    real = fp.run_experiment_foldparallel

    def fake(cfg, cohort, devices=None, ckpt_dir=None, resume=False, device="cuda"):
        seen.update(devices=devices, device=str(device))
        return real(cfg, cohort, devices, ckpt_dir, resume, device)

    monkeypatch.setattr(fp, "run_experiment_foldparallel", fake)
    res = cli.main(["--config", GBM, "--synthetic", "--debug", "--device", "cpu",
                    "--fold-parallel", "--set", "epochs=2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert seen == {"devices": None, "device": "cpu"}
    assert res["units"] == 5 and res["arm"] == "per-step"
    for k in ("cancer_type", "model", "pooled_auc", "pooled_auc_by_loss", "pooled_acc",
              "wall_time_s"):
        assert k in line
    assert line["pooled_auc"] == res["auc"][res["check_epochs"][-1]]


def test_cli_fold_parallel_parse_and_refusal(monkeypatch):
    import argparse

    parsed = {}
    real = argparse.ArgumentParser.parse_args

    def spy(self, argv=None, namespace=None):
        ns = real(self, argv, namespace)
        parsed["fold_parallel"] = ns.fold_parallel
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    for argv, want in ((["--fold-parallel"], 0), (["--fold-parallel", "4"], 4), ([], None)):
        with pytest.raises(SystemExit):
            cli.main(["--config", GBM, "--synthetic"] + argv)
        assert parsed["fold_parallel"] == want
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
    with pytest.raises(SystemExit) as e:
        cli.main(["--config", GBM, "--synthetic", "--fold-parallel", "--pretrain",
                  "autoencoder"])
    assert e.value.code == 2
