#!/usr/bin/env python3
"""Whether the protocol repeats bit for bit on the card, and where it
stops repeating: the reference-scale cohort of chip_smoke.py's cohort
phase (400 patients, 146 pathways, gbm.yaml, bf16 trunk), run_experiment
(1 run x 5 folds x 2 epochs) twice in one process under each setting:

  default       the fold prefetch thread on, as gbm.yaml sets it
  no_prefetch   fold_prefetch off: every fold derived on the main thread
  deterministic torch.use_deterministic_algorithms(True) and
                cudnn.deterministic, prefetch on

    python3 probes/protocol_repeat.py [SETTING ...]   (default: all three)

Prints, per setting, each fold's max |difference| of the test scores and
of the train-step losses between the two runs, and the derivation's
arrays that differ (MI, mask, PCA seeds, edges) between the two runs'
folds; then the card's nvidia-smi name and power limit.  Needs one CUDA
card and nvcc.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from multilevel_gnn_tpu_torch.core.config import Config  # noqa: E402
from multilevel_gnn_tpu_torch.data.loaders import load_cohort_from_files  # noqa: E402
from multilevel_gnn_tpu_torch.data.synthetic import write_reference_format  # noqa: E402
from multilevel_gnn_tpu_torch.train import driver  # noqa: E402

REF_COHORT = dict(n_patients=400, n_pathways=146, genes_per_pathway=38, overlap=3,
                  n_edges=60000, seed=2)


def run(cfg, cohort):
    folds, setups = [], []
    real_run, real_setup = driver.run_fold, driver.fold_setup

    def spy_run(*a, **k):
        folds.append(real_run(*a, **k))
        return folds[-1]

    def spy_setup(*a, **k):
        out = real_setup(*a, **k)
        setups.append(out[1])
        return out

    driver.run_fold, driver.fold_setup = spy_run, spy_setup
    try:
        driver.run_experiment(cfg, cohort, device="cuda")
    finally:
        driver.run_fold, driver.fold_setup = real_run, real_setup
    return folds, setups


def main() -> int:
    if not torch.cuda.is_available():
        print("protocol_repeat: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as root:
        write_reference_format(root, cancer_type="gbm", **REF_COHORT)
        base = Config.from_yaml(str(ROOT / "configs" / "gbm.yaml"))
        cohort = load_cohort_from_files(
            f"{root}/gbm/raw_mrna.csv", f"{root}/gbm/raw_cnv.csv",
            f"{root}/gbm/raw_methylation.csv", f"{root}/gbm/clinical.pkl",
            f"{root}/kegg.csv", f"{root}/pathways.txt", f"{root}/gbm/grn_edges.tsv", base)
        for setting in sys.argv[1:] or ("default", "no_prefetch", "deterministic"):
            cfg = base.replace(num_run=1, epochs=2,
                               fold_prefetch=setting != "no_prefetch")
            if setting == "deterministic":
                torch.use_deterministic_algorithms(True)
                torch.backends.cudnn.deterministic = True
            (fa, sa), (fb, sb) = run(cfg, cohort), run(cfg, cohort)
            row = {"setting": setting, "folds": []}
            for a, b in zip(fa, fb):
                row["folds"].append({
                    "test_score": float(np.abs(a.epoch_pred_by_epoch[2]
                                               - b.epoch_pred_by_epoch[2]).max()),
                    "step_loss": float(np.abs(np.array(a.step_losses)
                                              - np.array(b.step_losses)).max()),
                    "first_differing_step": next(
                        (i for i, (x, y) in enumerate(zip(a.step_losses, b.step_losses))
                         if x != y), None)})
            derivation = []
            for i, (x, y) in enumerate(zip(sa, sb)):
                diff = [k for k in ("mutual_info", "info_mask", "pca_seed")
                        if not np.array_equal(np.asarray(getattr(x, k)),
                                              np.asarray(getattr(y, k)))]
                gx, gy = x.ctx.graph, y.ctx.graph
                if not (torch.equal(gx.senders.cpu(), gy.senders.cpu())
                        and torch.equal(gx.edge_attr.cpu(), gy.edge_attr.cpu())):
                    diff.append("edges")
                derivation.append(diff)
            row["derivation_differs"] = derivation
            print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
