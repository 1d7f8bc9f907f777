#!/usr/bin/env python3
"""chip_smoke.py's fold-parallel phases alone, on the reference-scale
protocol files that its `cohort` phase writes: fold_parallel_plans and
fold_parallel_k1 / _k2 / _k3 (the stacked kernels at U = 5 and GBM width
against plain versions and per-unit launches), fold_parallel_step and
fold_parallel_serve (a stacked sage bf16 step and eval batch against five
units' own), fold_parallel_protocol (the train CLI with --fold-parallel
against the sequential CLI, and a small protocol card against CPU) and
fold_parallel_ckpt (resume and predict).

    PYTHONPATH=. python3 probes/fold_parallel_phases.py [plans|step|serve|protocol|ckpt ...]

With no argument every group runs.  Prints chip_smoke's JSON lines and the
card's nvidia-smi name and power limit.  Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import sys
import tempfile
import time

import torch

import chip_smoke as cs

GROUPS = ("plans", "step", "serve", "protocol", "ckpt")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("fold_parallel_phases: no CUDA device", file=sys.stderr)
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
    if {"plans", "step", "serve"} & set(groups):
        units = cs.fp_units()
        if "plans" in groups:
            cs.fp_plans_phase(units, gen)
        if "step" in groups:
            cs.fp_step_phase(units)
        if "serve" in groups:
            cs.fp_serve_phase(units)
        del units
        torch.cuda.empty_cache()
    if {"protocol", "ckpt"} & set(groups):
        with tempfile.TemporaryDirectory() as root:
            cohort = cs.cohort_phase(root)
            if "protocol" in groups:
                cs.fp_protocol_phase(root, cs.small_files(root))
            if "ckpt" in groups:
                cs.fp_ckpt_phase(root, cohort)
    cs.emit({"phase": "fold_parallel_probe", "groups": groups,
             "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
