#!/usr/bin/env python3
"""A sage train step's and eval step's time at the GBM fold of
chip_smoke.py, for whichever tree of the port is first on PYTHONPATH, so
two commits can be compared in turns on one card:

    PYTHONPATH=scratch/parent python3 probes/step_ms.py parent
    PYTHONPATH=. python3 probes/step_ms.py change

The fold is make_gbm_scale_setup(topology="cohort", windowed=True,
batch=32, bf16 trunk), the model's seed-0 weights, gbm.yaml's optimizer
and dropouts.  After 3 warm-up steps: 10 train steps timed with CUDA
events (median ms), then 5 under the profiler (kernel ms per step, the
sum of device kernel rows), and the same for eval steps; with the
windowed plan and without it (composed), with a train step's 25 largest
kernels (name, ms, launches).  Where the tree has
train/explain.py, one integrated_gradients call (16 steps) too: its
kernel ms.  Prints one JSON line per (tag, path) and the card's
nvidia-smi name and power limit.  Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from multilevel_gnn_tpu_torch.data.synthetic import make_gbm_scale_setup
from multilevel_gnn_tpu_torch.train.step import eval_step, make_optimizer, train_step


def kernel_ms(fn, n, top=None):
    """Kernel ms per fn() call over n calls; with top, also the top
    kernels' (name, ms per call, launches per call)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        rows.append((ev.key[:70], getattr(ev, "self_device_time_total", 0.0) / 1e3 / n,
                     ev.count / n))
    total = sum(r[1] for r in rows)
    if top is None:
        return total
    return total, sorted(rows, key=lambda r: -r[1])[:top]


def event_ms(fn, n):
    out = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def main() -> int:
    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model, graph, ctx, batch = make_gbm_scale_setup(
        topology="cohort", windowed=True, batch=32, compute_dtype="bfloat16",
        spmm_bf16=True, device="cuda")
    cw = torch.tensor([1.0, 1.5], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    opt = make_optimizer(model, cfg, 6)
    composed = dataclasses.replace(ctx, graph=dataclasses.replace(ctx.graph, winplan=None))
    has_ig = importlib.util.find_spec("multilevel_gnn_tpu_torch.train.explain") is not None
    for path, c in (("windowed", ctx), ("composed", composed)):
        step = lambda: train_step(model, opt, batch, c, cw, gen)  # noqa: E731
        ev = lambda: eval_step(model, batch, c)  # noqa: E731
        for _ in range(3):
            step()
            ev()
        torch.cuda.synchronize()
        train_ms, train_top = kernel_ms(step, 5, top=25)
        row = {"tag": tag, "path": path,
               "train_step_ms_median": event_ms(step, 10),
               "train_kernel_ms_per_step": train_ms, "train_top": train_top,
               "eval_step_ms_median": event_ms(ev, 10),
               "eval_kernel_ms_per_batch": kernel_ms(ev, 5)}
        if has_ig:
            from multilevel_gnn_tpu_torch.train.explain import integrated_gradients

            ig = lambda: integrated_gradients(model, batch, c, steps=16)  # noqa: E731
            ig()
            row["ig_kernel_ms_per_call"] = kernel_ms(ig, 2)
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
