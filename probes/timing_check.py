#!/usr/bin/env python3
"""Three clocks on the same kernel call, to check chip_smoke.py's device
ms where a reading falls below its byte bound: K4a on the GBM fold's
sorted receivers ((32, 153,538, 64) bf16 rows, as chip_smoke's `k4`), K1's
src_gather backward form and a device copy of the K4a rows.

    PYTHONPATH=. python3 probes/timing_check.py

Per case: the profiler's kernel records over 5 windows of 10 calls (each
window's record count and summed duration per call, as chip_smoke's
device_ms reads them), CUDA events around a loop of 50 calls (per call),
and CUDA events around single calls (median); the bytes the call must move
and the rate each clock implies.  Prints one JSON line per case and the
card's nvidia-smi name and power limit.  Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from multilevel_gnn_tpu_torch.data.synthetic import make_gbm_scale_setup
from multilevel_gnn_tpu_torch.ops.kernels import segment_sum as k1


def windows(fn, n=10, count=5):
    out = []
    for _ in range(count):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        recs = [(ev.key, ev.count, ev.self_device_time_total) for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
        out.append({"records": sum(c for _, c, _ in recs),
                    "ms_per_call": sum(t for _, _, t in recs) / 1e3 / n,
                    "kernels": [k[:60] for k, _, _ in recs]})
    return out


def loop_ms(fn, n=50):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def single_ms(fn, n=20):
    ms = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return float(np.median(ms))


def case(name, fn, nbytes):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    w = windows(fn)
    lm, sm = loop_ms(fn), single_ms(fn)
    print(json.dumps({"case": name, "bytes": nbytes, "windows": w, "loop_event_ms": lm,
                      "single_event_ms": sm,
                      "tb_per_s": {"profiler_median": nbytes / np.median(
                          [x["ms_per_call"] for x in w]) / 1e9,
                                   "loop_event": nbytes / lm / 1e9}}), flush=True)


def main():
    cfg, model, graph, ctx, batch = make_gbm_scale_setup(
        topology="cohort", windowed=True, batch=32, compute_dtype="bfloat16",
        spmm_bf16=True, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    plan = k1.SortedPlan.build(graph.receivers.cpu().numpy(), graph.n_nodes,
                               mask=graph.edge_mask.cpu().numpy()).to("cuda")
    data = torch.randn(32, plan.n_ids, 64, generator=gen, device="cuda").to(torch.bfloat16)
    out_bytes = 32 * plan.num_segments * 64 * 4
    case("K4a bf16", lambda: k1.sorted_segment_sum(data, plan),
         data.numel() * 2 + out_bytes)
    case("copy of the K4a rows", lambda: data.clone(), 2 * data.numel() * 2)
    g = graph.src_gather
    x = torch.randn(g.nnz, 2048, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.ones(g.nnz, device="cuda")
    case("K1 src_gather bf16", lambda: k1.segment_spmm_csr(x, w, g),
         x.numel() * 2 + graph.n_nodes * 2048 * 4)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip().splitlines()[0]
    print(smi, flush=True)


if __name__ == "__main__":
    main()
