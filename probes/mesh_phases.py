#!/usr/bin/env python3
"""chip_smoke.py's mesh phases alone: mesh_ws1 (an NCCL group of world size
1 on cuda:0), mesh_halo, mesh_step and mesh_protocol (two gloo ranks on
cuda:0), the per-rank kernel forms, and warm with the train CLI's
--bench-scaling.

    PYTHONPATH=. python3 probes/mesh_phases.py [nowarm]

mesh_protocol's single-device references (the small protocol on the card
and on the CPU) are made here as chip_smoke's experiment phase makes them.
Prints chip_smoke's JSON lines and the card's nvidia-smi name and power
limit.  Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import sys

import torch

import chip_smoke as cs


def small_scores() -> None:
    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.data.synthetic import make_synthetic_cohort
    from multilevel_gnn_tpu_torch.train import driver

    cfg = Config.from_yaml(cs.GBM_YAML).replace(
        num_run=1, epochs=2, compute_dtype=None, spmm_bf16=False, feature_drop=False,
        head_drop_rate=0.0, gnn_dropout=0.0)
    for dev in ("cuda", "cpu"):
        rec, undo = cs._spy_folds()
        try:
            out = driver.run_experiment(cfg, make_synthetic_cohort(cfg, **cs.SMALL_COHORT),
                                        device=dev)
        finally:
            undo()
        cs.SMALL_SCORES[dev] = (rec, out)


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_phases: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_setup(), flush=True)
    cs.build_phase()
    small_scores()
    cs.emit({"phase": "mesh_launches_ws1", **cs.mesh_ws1_phase()})
    paths, _ = cs.mesh_phases(torch.Generator(device="cuda").manual_seed(0))
    cs.emit({"phase": "mesh_paths", **paths})
    if "nowarm" not in sys.argv[1:]:
        cs.bench_scaling_phase(*cs.warm_phase())
    return 0


if __name__ == "__main__":
    sys.exit(main())
