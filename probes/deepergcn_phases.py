#!/usr/bin/env python3
"""chip_smoke.py's DeeperGCN phases alone, on the reference-scale protocol
files that its `cohort` phase writes: deepergcn_fold, k3_gene, k1_gene,
slice_deepergcn, serve_deepergcn, profile_deepergcn, train_grad_deepergcn,
profile_train_deepergcn and experiment_deepergcn, then the `cuda` tests of
GENConv's kernels.

    PYTHONPATH=. python3 probes/deepergcn_phases.py

A quicker check of the DeeperGCN path than the whole script (about 100 s
on an H100 against 280).  Prints chip_smoke's JSON lines and the card's
nvidia-smi name and power limit.  Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke as cs
from multilevel_gnn_tpu_torch.ops.kernels import build


def main() -> int:
    if not torch.cuda.is_available():
        print("deepergcn_phases: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    build.build_all()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as root:
        cohort = cs.cohort_phase(root)
        t0 = time.perf_counter()
        cs.deepergcn_phases(root, cohort, gen)
        cs.emit({"phase": "deepergcn_phases", "seconds": time.perf_counter() - t0})
    return subprocess.run([sys.executable, "-m", "pytest", "tests/test_torch_cuda_kernels.py",
                           "-m", "cuda", "-q", "--noconftest", "-p", "no:cacheprovider",
                           "-k", "genconv or gene"]).returncode


if __name__ == "__main__":
    sys.exit(main())
