#!/usr/bin/env python3
"""K1's forms timed through the package's API, on whichever tree is first
on PYTHONPATH, so two trees can be compared on one card in turns:

    PYTHONPATH=scratch/parent python3 probes/k1_turns.py parent
    PYTHONPATH=. python3 probes/k1_turns.py change

(scratch/parent: `git archive <commit> | tar -x -C scratch/parent`.)
Forms: the GBM fold of chip_smoke.py (make_gbm_scale_setup, bf16 and f32,
F 2,048: csr, csc, the windowed residual, tres and res_csc in accumulate
mode, the edge-gather backwards; the gather_rows backward at F 1,024; GAT's
softmax denominators at F 256 and 128 and its gather backward at F 256,
f32), DeeperGCN's edge-id lookup backward (one row of 120,001 entries into
5,548 table rows, (E, 128) f32) alone and five stacked, and the kNN graph's
gather backwards (knn_graph at N 15,405, k 9, plans built on the card, F
64 f32); then DynConv's and ResDynBlock's forward and backward at that
size (device ms of 10 calls, the kNN plans built in each forward).  Each form: device ms a call (torch.profiler, the median of 3
windows of 20 calls), the byte bound at 3.35 TB/s, index_add_'s ms where
one call computes the same function (an f32 gather backward whose plan
reads every row of x once), the error
against the plain version and whether two calls are equal bit for bit.
One JSON line a form, then the card's nvidia-smi name and power limit.
Needs one CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12


def device_ms(fn, iters=20, windows=3, warmup=3):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        got.append(sum(getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()
                       if ev.device_type == DeviceType.CUDA) / 1e3 / iters)
    return float(np.median(got))


def bound_ms(plan, F, dsize, acc):
    rows_read = int(torch.unique(plan.col).numel())
    with_edges = int((plan.rowptr[1:] > plan.rowptr[:-1]).sum())
    out_rows = 2 * with_edges if acc else plan.n_rows
    b = rows_read * F * dsize + out_rows * F * 4 + (plan.n_rows + 1) * 4 + plan.nnz * 8
    b += int(torch.unique(plan.eid).numel()) * 4
    return b / HBM_BYTES_PER_S * 1e3


def forms(gen):
    from multilevel_gnn_tpu_torch.data.synthetic import make_gbm_scale_setup
    from multilevel_gnn_tpu_torch.nn.conv import dynamic_graph
    from multilevel_gnn_tpu_torch.ops import spmm
    from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import CSRPlan
    from multilevel_gnn_tpu_torch.ops.knn import knn_graph

    _, _, graph, ctx, _ = make_gbm_scale_setup(
        topology="cohort", windowed=True, batch=32, compute_dtype="bfloat16",
        spmm_bf16=True, device="cuda")
    w = spmm.edge_weights(graph, "mean", graph.edge_attr)
    wp, N, E = graph.winplan, graph.n_nodes, graph.num_padded_edges
    bf, f32 = torch.bfloat16, torch.float32
    # name, plan, x rows, F, dtype, accumulate, weights (None: ones), index_add_
    yield from [("csr", graph.csr, N, 2048, bf, False, w, False),
                ("csr", graph.csr, N, 2048, f32, False, w, False),
                ("csc", graph.csc, N, 2048, bf, False, w, False),
                ("csc", graph.csc, N, 2048, f32, False, w, False),
                ("residual", wp.res, N, 2048, bf, True, w, False),
                ("residual", wp.res, N, 2048, f32, True, w, False),
                ("tres", wp.tres, N, 2048, bf, True, w, False),
                ("res_csc", wp.res_csc, N, 2048, bf, True, w, False),
                ("gather_rows_bwd", ctx.pca_gather, ctx.num_pca_rows, 1024, bf, False, None,
                 True),
                ("src_gather_bwd", graph.src_gather, E, 2048, bf, False, None, True),
                ("dst_gather_bwd", graph.dst_gather, E, 2048, bf, False, None, True),
                ("gat_denominators", graph.dst_gather, E, 256, f32, False, None, True),
                ("gat_denominators", graph.dst_gather, E, 128, f32, False, None, True),
                ("gat_src_gather_bwd", graph.src_gather, E, 256, f32, False, None, True)]
    del graph, ctx, wp
    lookup = CSRPlan.gather(np.zeros(120_001, np.int64), 5_548)
    yield ("edge_id_lookup_bwd", lookup.to("cuda"), 120_001, 128, f32, False, None, True)
    stacked = CSRPlan.stack([lookup] * 5, 120_001, 120_001)
    yield ("stacked_edge_id_lookup_bwd", stacked.to("cuda"), 5 * 120_001, 128, f32, False,
           None, True)
    knn = dynamic_graph(*knn_graph(torch.randn(15_405, 64, generator=gen, device="cuda"), 9),
                        15_405)
    yield ("knn_gather_src_bwd", knn.src_gather, knn.n_edges, 64, f32, False, None, True)
    yield ("knn_gather_dst_bwd", knn.dst_gather, knn.n_edges, 64, f32, False, None, True)


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_turns: no CUDA device", file=sys.stderr)
        return 2
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    from multilevel_gnn_tpu_torch.ops.kernels import segment_sum as k1

    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, plan, rows, F, dt, acc, w, lib in forms(gen):
        x = torch.randn(rows, F, generator=gen, device="cuda").to(dt)
        if w is None:
            w = torch.ones(max(plan.max_eid + 1, 1), device="cuda")
        base = torch.randn(plan.n_rows, F, generator=gen, device="cuda") if acc else None
        buf = base.clone() if acc else None
        a = k1.segment_spmm_csr(x, w, plan, base.clone() if acc else None)
        b = k1.segment_spmm_csr(x, w, plan, base.clone() if acc else None)
        ref = k1.segment_spmm_csr_plain(x, w, plan, base.clone() if acc else None)
        torch.cuda.synchronize()
        line = {"tree": label, "form": name, "F": F, "dtype": str(dt)[6:], "nnz": plan.nnz,
                "ms": device_ms(lambda: k1.segment_spmm_csr(x, w, plan, buf)),
                "bound_ms": bound_ms(plan, F, 2 if dt == torch.bfloat16 else 4, acc),
                "max_abs_err": float((a - ref).abs().max()),
                "ref_max": float(ref.abs().max()), "bitwise_repeat": bool(torch.equal(a, b))}
        if lib and dt == torch.float32 and plan.nnz == rows:
            # the function as one index_add_ where the plan reads each row
            # of x once: row col[e] of x added into output row row[e]
            idx = torch.empty(rows, dtype=torch.long, device="cuda").scatter_(
                0, plan.col.long(), plan.row.long())
            line["library_ms"] = device_ms(lambda: torch.zeros(
                plan.n_rows, F, device="cuda").index_add_(0, idx, x))
        print(json.dumps(line), flush=True)
    # the knock-on: DynConv and ResDynBlock (kNN graph and plans built on
    # the card in every forward, K1 twice in the backward), fwd + bwd
    from multilevel_gnn_tpu_torch.nn.blocks import DynConv, ResDynBlock

    x = torch.randn(15_405, 64, generator=gen, device="cuda")
    cot = torch.randn(15_405, 64, generator=gen, device="cuda")
    for name, blk in (("DynConv", DynConv(64, 64, 9)), ("ResDynBlock", ResDynBlock(64, 9))):
        blk = blk.to("cuda")

        def run(blk=blk):
            xi = x.clone().requires_grad_(True)
            blk.zero_grad(set_to_none=True)
            blk(xi).backward(cot)

        print(json.dumps({"tree": label, "form": f"{name}_fwd_bwd", "F": 64, "dtype": "float32",
                          "nnz": 15_405 * 9, "ms": device_ms(run, iters=10), "bound_ms": 0.0,
                          "max_abs_err": 0.0, "ref_max": 0.0, "bitwise_repeat": True}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
