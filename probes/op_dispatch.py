#!/usr/bin/env python3
"""Host cost of one kernel call through the port's wrapper, for whichever
tree of the port is first on PYTHONPATH, so two commits can be compared in
turns on one card:

    PYTHONPATH=scratch/parent python3 probes/op_dispatch.py parent
    PYTHONPATH=. python3 probes/op_dispatch.py change

K1 (segment_spmm_csr) over a small plan (2,000 rows, 8,000 edges, F = 64,
bf16), whose kernel takes a few microseconds, so a loop of calls is bound
by the host: the CUDA-event time of 2,000 calls in a row, per call, median
of 5 loops, after a warm-up; and the same for K2 (windowed_tile_spmm) on
the plan's forward side.  Prints one JSON line with the card's nvidia-smi
name and power limit.  Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from multilevel_gnn_tpu_torch.ops.kernels import segment_sum as k1
from multilevel_gnn_tpu_torch.ops.kernels import windowed as k2

CALLS, LOOPS = 2000, 5


def per_call_us(fn):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(LOOPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(CALLS):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) * 1e3 / CALLS)
    return float(np.median(out)), out


def main():
    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    rng = np.random.RandomState(0)
    n, e = 2000, 8000
    src = rng.randint(0, n, e)
    dst = np.clip(src + rng.randint(-100, 101, e), 0, n - 1)
    plan = k1.CSRPlan.build(dst, src, np.arange(e), n).to("cuda")
    wplan = k2.build_plan(src, dst, n).to("cuda")
    x = torch.randn(n, 64, device="cuda").to(torch.bfloat16)
    w = torch.rand(e, device="cuda")
    k1_us, k1_all = per_call_us(lambda: k1.segment_spmm_csr(x, w, plan))
    k2_us, k2_all = per_call_us(lambda: k2.windowed_tile_spmm(x, w, wplan))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip().splitlines()[0]
    print(json.dumps({"tag": tag, "k1_us_per_call": k1_us, "k1_loops": k1_all,
                      "k2_us_per_call": k2_us, "k2_loops": k2_all, "nvidia_smi": smi}))


if __name__ == "__main__":
    main()
