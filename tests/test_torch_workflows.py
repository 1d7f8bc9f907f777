"""The port's warm, profiling and timing workflows on the CPU
(train/warm.py, utils/profiling.py, the train CLI's --profile-dir).

- StepTimer times its steps and counts edges/s; AverageMeter; MetricStream
  appends one JSON line per call; enable_nan_debug turns on anomaly mode.
- trace() writes a Chrome trace of the block; the train CLI with
  --profile-dir writes one for the whole experiment, naming the kernels'
  plain versions' ops and the custom op mgtpu::segment_spmm_csr.
- warm_experiment builds the data libraries with g++ into a fresh build
  directory, then derives fold 0; the warm CLI in one process leaves the
  next train CLI process nothing to build (every build 0.0 s).
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.data import native
from multilevel_gnn_tpu_torch.data.synthetic import make_synthetic_cohort
from multilevel_gnn_tpu_torch.train import cli, warm
from multilevel_gnn_tpu_torch.utils import profiling
from torch_threads import child_env, few_threads  # noqa: F401  (few_threads: autouse)

REPO = Path(__file__).resolve().parents[1]
GBM = str(REPO / "configs" / "gbm.yaml")
SMALL = ["num_run=1", "epochs=1", "node_embedding_dim=4", "hidden_channels=8",
         "final_channels=4", "head_dim=16", "conv_channel_list=[8,16]"]


def test_step_timer_meter_stream(tmp_path):
    timer = profiling.StepTimer(edges_per_step=1000, batch_per_step=4)
    for _ in range(3):
        with timer.step() as out:
            time.sleep(0.01)
            out["result"] = torch.ones(3) * 2
    assert len(timer.times) == 3 and all(t >= 0.01 for t in timer.times)
    assert abs(timer.edges_per_s - 4000 / timer.mean_s) < 1e-6
    assert profiling.StepTimer().edges_per_s == 0.0
    m = profiling.AverageMeter()
    m.update(2.0, n=3)
    m.update(4.0)
    assert m.avg == 2.5 and m.val == 4.0 and m.count == 4
    path = str(tmp_path / "m.jsonl")
    s = profiling.MetricStream(path)
    s.log(epoch=1, auc=0.5)
    s.log(epoch=2, auc=0.75, ts=1.0)
    s.close()
    lines = [json.loads(l) for l in open(path)]
    assert [l["epoch"] for l in lines] == [1, 2] and lines[1]["ts"] == 1.0
    assert "ts" in lines[0]


def test_nan_debug_is_anomaly_mode():
    prev = torch.is_anomaly_enabled()
    try:
        profiling.enable_nan_debug()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(prev)


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        a = torch.randn(64, 64)
        (a @ a).sum()
    path = tmp_path / "prof" / profiling.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)


def test_train_cli_profile_dir(tmp_path, capsys):
    prof = tmp_path / "prof"
    cli.main(["--config", GBM, "--synthetic", "--debug", "--device", "cpu",
              "--profile-dir", str(prof), "--set", *SMALL])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["builds"]) == {"mi_knn", "csv_float"}
    text = (prof / profiling.TRACE_FILE).read_text()
    assert "mgtpu::segment_spmm_csr" in text


def test_warm_experiment_builds_data_libraries(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "_BUILD_S", {})
    cfg = Config.from_yaml(GBM, num_run=1, epochs=1)
    cohort = make_synthetic_cohort(cfg, seed=0, n_patients=40, n_pathways=4)
    out = warm.warm_experiment(cfg, cohort, "cpu")
    assert set(out["builds"]) == {"mi_knn", "csv_float", "fold0"}
    assert all(s > 0 for s in out["builds"].values())
    assert out["warm_s"] >= sum(out["builds"].values()) - 1e-6
    assert sorted(p.name.split("-")[0] for p in (tmp_path / "build").glob("*.so")) == [
        "csv_float", "mi_knn"]
    # fold 0's MI mask is kept for this process
    assert 0 in cohort._mask_cache


def test_warm_cli_then_train_cli_builds_nothing(tmp_path):
    env = child_env()
    args = ["--config", GBM, "--synthetic", "--debug", "--device", "cpu", "--set", *SMALL]

    def run(module):
        r = subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                           text=True, env=env, timeout=300, cwd=str(tmp_path))
        assert r.returncode == 0, r.stderr
        return json.loads(r.stdout.strip().splitlines()[-1])

    w = run("multilevel_gnn_tpu_torch.train.warm")
    assert {"mi_knn", "csv_float", "fold0"} <= set(w["builds"]) and w["warm_s"] > 0
    t = run("multilevel_gnn_tpu_torch.train.cli")
    assert t["builds"] == {"mi_knn": 0.0, "csv_float": 0.0}
    assert np.isfinite(t["pooled_auc"])
