"""The port's protocol on a mesh (train/driver.py's mesh path) and the
train CLI's --mesh / --bench-scaling, on gloo ranks of the CPU.

run_experiment on the tiny synthetic cohort of tests/torch_parallel.py
(gbm.yaml at small widths, its dropouts on, 2 epochs): a 2 x 2 mesh, the
halo form on 1 x 4 (halo_exchange, windowed interiors), DeeperGCN with
softmax aggregation on 2 x 2, and gat and mr on 1 x 2, each against the
single-device run: pooled AUC, AUC by loss, AUC by epoch and ACC within
rtol 1e-5, atol 1e-6 (JAX's tolerance, tests/test_driver_parallel_ckpt.py
:51-54).  An interrupted 1 x 2 run resumed in a fresh group equals the
uninterrupted one within atol 1e-12; only rank 0 writes the checkpoints.
MultiOmixGCN and the autoencoder fail on the mesh with the sequential
driver's errors.  Against the JAX package's run_experiment on the same
2 x 2 mesh (the conftest's virtual devices), dropouts off, each fold
starting from JAX's initial parameters, on test_torch_experiment.py's
reference-format cohort: pooled metrics as above.

The CLI: --mesh 2x1 --device cpu --synthetic --debug prints its JSON line
once (rank 0), equal to the single-device line's metrics;
--fold-parallel --mesh 1x2 exits 2 with JAX's message; --bench-scaling
--device cpu prints JAX's keys (and the CLI's builds).
"""
import json

import flax
import numpy as np
import pytest

from multilevel_gnn_tpu.data import loaders as jloaders
from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.train import driver as jdriver
from multilevel_gnn_tpu_torch.data.synthetic import write_reference_format
from multilevel_gnn_tpu_torch.train import cli

import torch_parallel as TP
from test_torch_experiment import GBM, KW as JAX_KW, _paths
from torch_threads import few_threads  # noqa: F401  (autouse)

KEYS = ("auc", "auc_by_loss", "auc_by_epoch", "acc")
MESH4 = {
    "2x2": ({}, (2, 2), {}),
    "halo_1x4": ({"halo_exchange": True}, (1, 4), {}),
    "deepergcn_2x2": (dict(TP.DGCN, gcn_aggr="softmax"), (2, 2), {}),
    "multiomix_2x2": ({"model": "multiomix"}, (2, 2), {}),
    "autoencoder_2x2": ({"model": "autoencoder"}, (2, 2), {}),
}
SINGLE = {"2x2": {}, "halo_1x4": {"halo_exchange": True},
          "deepergcn_2x2": MESH4["deepergcn_2x2"][0], "gat_1x2": {"gnn_name": "gat"},
          "mr_1x2": {"gnn_name": "mr"}}


def check(got, want, rtol=1e-5, atol=1e-6):
    e = want["check_epochs"][-1]
    assert got["check_epochs"] == want["check_epochs"]
    for key in KEYS:
        np.testing.assert_allclose(got[key][e], want[key][e], rtol=rtol, atol=atol,
                                   err_msg=key)


@pytest.fixture(scope="module")
def mesh4():
    return TP.run_ranks(TP.experiment_rank, 4, MESH4)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_ckpt"))


@pytest.fixture(scope="module")
def mesh2(ckpt_dir):
    """gat and mr on 1 x 2, an uninterrupted 1 x 2 run, and the same run
    interrupted after 3 epochs with checkpoints every epoch."""
    cases = {
        "gat_1x2": ({"gnn_name": "gat"}, (1, 2), {}),
        "mr_1x2": ({"gnn_name": "mr"}, (1, 2), {}),
        "whole": ({"ckpt_every": 1}, (1, 2), {}),
        "interrupted": ({"ckpt_every": 1}, (1, 2),
                        {"ckpt_dir": ckpt_dir, "interrupt_after": [3]}),
    }
    return TP.run_ranks(TP.experiment_rank, 2, cases)


@pytest.fixture(scope="module")
def resumed(mesh2, ckpt_dir):
    """The interrupted run resumed in a fresh group of two ranks."""
    assert mesh2[0]["interrupted"]["error"] == "KeyboardInterrupt"
    cases = {"resumed": ({"ckpt_every": 1}, (1, 2), {"ckpt_dir": ckpt_dir, "resume": True})}
    return TP.run_ranks(TP.experiment_rank, 2, cases)


@pytest.fixture(scope="module")
def single():
    return {name: TP.driver.run_experiment(TP.tiny(**kw), TP.synthetic(TP.tiny(**kw)),
                                           device="cpu")
            for name, kw in SINGLE.items()}


@pytest.mark.parametrize("name", ["2x2", "halo_1x4", "deepergcn_2x2"])
def test_mesh4_matches_single_device(mesh4, single, name):
    for r in mesh4:
        assert "error" not in r[name], r[name].get("trace")
        check(r[name], single[name])


@pytest.mark.parametrize("name", ["gat_1x2", "mr_1x2"])
def test_mesh2_matches_single_device(mesh2, single, name):
    for r in mesh2:
        assert "error" not in r[name], r[name].get("trace")
        check(r[name], single[name])


@pytest.mark.parametrize("name,kw", [("multiomix_2x2", {"model": "multiomix"}),
                                     ("autoencoder_2x2", {"model": "autoencoder"})])
def test_mesh_fails_as_sequential(mesh4, name, kw):
    err, msg = TP.sequential_error(kw)
    assert err is not None
    for r in mesh4:
        assert (r[name]["error"], r[name]["message"]) == (err, msg)


def test_resume_in_fresh_group_equals_uninterrupted(mesh2, resumed, ckpt_dir):
    import os

    whole = mesh2[0]["whole"]
    for r in resumed:
        got = r["resumed"]
        assert "error" not in got, got.get("trace")
        e = whole["check_epochs"][-1]
        for key in KEYS + ("acc_by_loss", "acc_by_epoch"):
            np.testing.assert_allclose(got[key][e], whole[key][e], rtol=0, atol=1e-12,
                                       err_msg=key)
    assert sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npy")) == [
        f"result_run0_fold{i}.npy" for i in range(5)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cohort"))
    write_reference_format(d, seed=4, cancer_type="gbm", n_patients=60, n_pathways=5)
    return d


def test_matches_jax_on_the_same_mesh(files, monkeypatch):
    """JAX's run_experiment on a 2 x 2 mesh (GSPMD) and the port's on 2 x 2
    ranks, dropouts off, epochs 2, each fold from JAX's initial
    parameters."""
    kw = dict(JAX_KW, epochs=2)
    inits = []
    real = jdriver.seed_pca_params

    def spy(params, seed):
        inits.append({k: np.asarray(v) for k, v in
                      flax.traverse_util.flatten_dict(params, sep="/").items()})
        return real(params, seed)

    monkeypatch.setattr(jdriver, "seed_pca_params", spy)
    jcohort = jloaders.load_cohort_from_files(cfg=JConfig.from_yaml(GBM, **kw),
                                              **_paths(files))
    jout = jdriver.run_experiment(
        jcohort.cfg.replace(mesh_data_axis=2, mesh_model_axis=2), jcohort)
    assert len(inits) == 5
    got = TP.run_ranks(TP.experiment_rank, 4, {"jax": (kw, (2, 2), {})},
                       {"jax": inits}, (GBM, _paths(files)))
    for r in got:
        assert "error" not in r["jax"], r["jax"].get("trace")
        check(r["jax"], jout)


def _lines(text):
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            pass
    return out


def test_cli_mesh_prints_once(capfd):
    argv = ["--config", GBM, "--synthetic", "--debug", "--device", "cpu"]
    want = cli.main(argv)
    capfd.readouterr()
    got = cli.main(argv + ["--mesh", "2x1"])
    lines = [o for o in _lines(capfd.readouterr().out) if "pooled_auc" in o]
    assert len(lines) == 1
    check(got, want)
    e = want["check_epochs"][-1]
    assert lines[0]["pooled_auc"] == got["auc"][e]


def test_cli_fold_parallel_with_mesh_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--config", GBM, "--synthetic", "--debug", "--device", "cpu",
                  "--fold-parallel", "--mesh", "1x2"])
    assert e.value.code == 2
    assert "--fold-parallel is incompatible with --pretrain/--mesh" in capsys.readouterr().err


def test_cli_bench_scaling(capfd):
    out = cli.main(["--config", GBM, "--synthetic", "--bench-scaling", "--device", "cpu"])
    lines = [o for o in _lines(capfd.readouterr().out)
             if o.get("metric") == "halo_scaling_efficiency"]
    assert len(lines) == 1 and lines[0] == json.loads(json.dumps(out))
    keys = {"metric", "value", "unit", "backend", "n_devices", "E", "B", "C", "sizes", "ms",
            "edges_per_s_per_chip", "efficiency", "wire_bytes_per_conv",
            "psum_equiv_bytes", "halo_H"}
    assert set(out) == keys | {"builds"}  # JAX's, then the port CLI's builds
    assert out["backend"] == "cpu" and out["sizes"] == [1] and out["value"] == 1.0
    assert out["E"] == 153_538 and (out["B"], out["C"]) == (2, 64)
    assert out["ms"]["1"] > 0
