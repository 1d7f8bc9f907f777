#!/usr/bin/env python3
"""chip_smoke.py's fold-parallel phases of DeeperGCN, PathCNN and
vae_finetune alone: on the five GBM-scale units, the stacked vae_finetune
step and serving (DiffPool, ConvHead) and the stacked PathCNN step
(group gbm); on the reference-scale protocol files that chip_smoke's
`cohort` phase writes, the five DeeperGCN folds' stacked kernels (group
kernels) and the stacked DeeperGCN step and serving at the U that fits
the card (group step); on the small files, the families' fold-parallel
protocols card against CPU, DeeperGCN's resume and predict (group
protocol).

    PYTHONPATH=. python3 probes/fold_parallel_families_phases.py [gbm|kernels|step|protocol ...]

With no argument every group runs.  Prints chip_smoke's JSON lines and the
card's nvidia-smi name and power limit.  Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import sys
import tempfile
import time

import torch

import chip_smoke as cs

GROUPS = ("gbm", "kernels", "step", "protocol")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("fold_parallel_families_phases: no CUDA device", file=sys.stderr)
        return 2
    groups = argv or list(GROUPS)
    unknown = set(groups) - set(GROUPS)
    if unknown:
        print(f"unknown groups {sorted(unknown)}; choose from {GROUPS}", file=sys.stderr)
        return 2
    print(cs.card_setup(), flush=True)
    cs.build_phase()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    if "gbm" in groups:
        units = cs.fp_units()
        cs.fpf_gbm_phases(units)
        del units
        torch.cuda.empty_cache()
    if {"kernels", "step", "protocol"} & set(groups):
        with tempfile.TemporaryDirectory() as root:
            if {"kernels", "step"} & set(groups):
                cohort = cs.cohort_phase(root)
                folds = cs.fpd_folds(cohort)
                if "kernels" in groups:
                    cs.fpd_kernel_phase(folds, gen)
                if "step" in groups:
                    cs.fpd_step_phases(folds, cohort)
                del folds, cohort
                torch.cuda.empty_cache()
            if "protocol" in groups:
                cs.fpf_protocol_phase(cs.small_files(root))
    cs.emit({"phase": "fold_parallel_families_probe", "groups": groups,
             "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
