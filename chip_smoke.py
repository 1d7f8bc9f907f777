#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
hold every kernel, forward and backward, against its plain PyTorch version.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU and nvcc (CUDA_HOME, PATH or /usr/local/cuda).
Exits non-zero, printing no result, without a card.  Phases, one JSON line
each:

  device   card name, count, nvidia-smi name/power limit, precision flags
  build    nvcc of every kernel source, in parallel (seconds)
  setup    GBM-scale fold: N = 15,405 node slots, E ~ 154k edges incl. self
           loops, cohort topology with the windowed plan, B = 32, bf16 trunk
  k1 / k2  each kernel at the main path's shapes, bf16 and f32, against its
           plain version (max abs error, stated tolerance, median ms of the
           kernel, the plain version and the torch.sparse.mm library call)
  serve    the main path: predict_patients over 4 batches (123 patients, the
           last batch padded), launch counts zeroed just before, read just
           after; ms per batch
  slice    the forward with kernels against the forward with plain versions
           on the card (bf16 and f32 trunks; probabilities and the pathway
           image), and a small fold on the card against the same fold on
           the CPU
  profile  device time by kernel over full-batch eval steps;
           serve_paths: windowed against composed (K1 on all edges) per
           batch, each path's launch counts, and the share of the windowed
           eval_step with no kernel running
  k1_bwd / k2_bwd  the backward forms at the training path's shapes, bf16
           and f32, against their plain versions: K1 over csc (all edges),
           over tres and over res_csc (accumulating), K1 as the gather_rows
           backward (F = B*32), K2 on the transpose side; with the
           transpose plan's sub-block, entry and tres counts
  train_grad  one train step's gradients with kernels against the same
           step with plain versions, per parameter max|diff| / max|grad|,
           bf16 and f32 trunks
  train    the training path: run_fold on a GBM-scale fold (gbm.yaml's
           optimizer and dropouts, 3 epochs), launch counts zeroed just
           before and read just after; ms per train step, host wall per
           epoch, launches per step, losses, parameter movement, valid and
           test AUC; then epoch 1 again from the same seeds, its first
           steps' losses against the first run's
  profile_train  device time by kernel per train step, and the share of
           the step with no kernel running
  k3       K3 (segment max) at the max-aggregation convs' shapes, F = B*C =
           2048 and B*32 = 1024, bf16 and f32, against its plain version
           (max abs error must be 0), with its ms, plain ms, bound and the
           scatter_reduce amax library call; k1_bwd also times K1 as the
           backward of the two edge gathers (src_gather, dst_gather)

Then, for each of gnn_name mr (MRConv) and edge (EdgeConv) on the same fold,
with a model of the same widths:

  serve_<conv>  predict_patients over the 123 patients, launch counts
           zeroed just before and read just after: K3 2, K1 0, K2 0 a batch
  profile_<conv>  device time by kernel per eval step of one full batch,
           and the share of the CUDA-event-timed eval step with no kernel
  slice_<conv>  the forward with kernels against plain versions (bf16 and
           f32 trunks; probabilities and the pathway image)
  train_grad_<conv>  one train step's gradients, kernels against plain
           versions, per parameter max|diff| / max|grad|
  train_<conv>  run_fold for 2 epochs (gbm.yaml's optimizer and dropouts),
           launches counted over it; ms per step
  profile_train_<conv>  as profile_train, on one batch: launches per step
           from the counters, K3 2, K1 5 (the two edge-gather backwards of
           each layer and the PCA gather's), K2 0

Then the sorted segment-sum and the protocol from files:

  k4       K4 at the GBM fold's sorted receivers: K4a on (B, E, C) =
           (32, 153,538, 64) rows, K4b on (E, B*C) rows, bf16 and f32, and
           segment_sum_by through a non-identity perm with 10% of the rows
           masked out, each against its plain version (1e-5 x max(1,
           max|ref|)), with its ms, plain ms, bound and torch.segment_reduce
  cohort   a reference-scale synthetic cohort (400 patients, 146 pathways)
           written in the reference's file layout, loaded with gbm.yaml and
           fold 0 derived; seconds by stage, the MI estimator's seconds at
           k = 7 and 15, node slots, edges, mask share, whether the
           windowed plan engaged
  experiment  the train CLI's main on those files, 1 run x 5 folds x 5
           epochs at gbm.yaml's widths, bf16, launch counts zeroed just
           before and read just after (K1 > 0; K2 as the folds' plans say);
           per-fold derivation s, ms per step, host s per epoch, pooled AUC
           and ACC; then a small protocol (f32, dropout off, 2 epochs) on
           the card and on the CPU, fold test scores within 1e-4

Kernel cases off the main path (other feature widths, permuted plans,
empty plans) are in tests/test_torch_cuda_kernels.py.

Then the card's nvidia-smi line, the kernels line (per kernel: its serving
numbers, its launches on each path and per train step, its backward forms'
and other forms' numbers) and the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from multilevel_gnn_tpu_torch.data.synthetic import make_gbm_scale_setup
from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
from multilevel_gnn_tpu_torch.ops import spmm
from multilevel_gnn_tpu_torch.ops.kernels import build
from multilevel_gnn_tpu_torch.ops.kernels import segment_max as k3
from multilevel_gnn_tpu_torch.ops.kernels import segment_sum as k1
from multilevel_gnn_tpu_torch.ops.kernels import windowed as k2
from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import SORTED_KERNEL as k4
from multilevel_gnn_tpu_torch.train import metrics as M
from multilevel_gnn_tpu_torch.train.driver import class_weight, iter_batches, run_fold
from multilevel_gnn_tpu_torch.train.predict import predict_patients
from multilevel_gnn_tpu_torch.train.step import (
    eval_step,
    make_loss_fn,
    make_optimizer,
    train_step,
)

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16_tensor": 989e12, "f32": 67e12}

N_PATIENTS = 123  # 4 batches of 32, the last one padded
TOL_BF16 = 2e-3   # per kernel, times max(1, max|plain|): bf16 A entries may
#                   round differently when their f32 sums differ in order
TOL_F32 = 1e-4    # per kernel, times max(1, max|plain|): f32 sum order
# Whole forward, kernels against plain versions on the card.  Readings on
# an H100 (PERF.md): probabilities 6.0e-8 in both trunks; the pathway image
# 2.3e-4 (bf16 trunk) and 9.3e-8 (f32 trunk) times max|image|.
TOL_PROB = 1e-6
TOL_IMAGE_BF16 = 1e-3  # times max|image|
TOL_IMAGE_F32 = 1e-6   # times max|image|
TOL_PROB_CPU = 1e-5    # a small fold on the card against the CPU (read 6.0e-8)
# One train step's gradients, kernels against plain versions, per parameter
# max|diff| / max|grad| (worst parameter).  Readings on an H100 (PERF.md):
# 7.2e-3 in the bf16 trunk (bf16 casts of f32 sums taken in another order
# can round one ulp apart), 6.3e-7 in the f32 trunk; limits about ten times.
TOL_GRAD = {"bf16": 7e-2, "f32": 6e-6}
TOL_REPLAY = 1e-5  # epoch 1 replayed from the same seeds: max |loss diff|
N_TRAIN_PATIENTS = 256  # 192 train (6 steps an epoch), 32 valid, 32 test
# The max-aggregation convs.  K3 selects one of its inputs, so its forward
# equals the plain version's exactly (limit 0), and so does a forward that
# differs from the plain one only in K3: slice_mr and slice_edge read 0.0 in
# both trunks on an H100 (PERF.md), held to TOL_PROB and TOL_IMAGE_F32 in
# both.  A step's gradients also run K1 (the edge gathers' backwards)
# against index_add_'s atomics.  Readings on an H100 (PERF.md): 1.4e-3 (bf16, edge), 4.0e-7 (f32); limits
# about ten times.
TOL_GRAD_MAX = {"bf16": 1.4e-2, "f32": 4e-6}
CONV_EPOCHS = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def bound(bytes_moved: float, flops: float, rate: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_spmm(rows, cols, vals, n_rows, n_cols, x):
    """torch.sparse.mm of the same weighted adjacency, as a yardstick only.
    Returns a callable, or None when torch has no sparse product for x's
    dtype on this card."""
    a = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), vals.to(x.dtype), (n_rows, n_cols)
    ).coalesce().to_sparse_csr()
    try:
        torch.sparse.mm(a, x)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError):
        return None
    return lambda: torch.sparse.mm(a, x)


def err_of(out, ref):
    return float((out - ref).abs().max()), float(ref.abs().max())


def check(name, err, ref_max, tol):
    limit = tol * max(1.0, ref_max)
    if not (err <= limit):
        raise AssertionError(f"{name}: max abs err {err} > {limit}")
    return limit


def k1_bytes_flops(plan, F, dsize, accumulate):
    cols = plan.col.long()
    rows_read = int(torch.unique(cols).numel())
    rows_with_edges = int((plan.rowptr[1:] > plan.rowptr[:-1]).sum())
    out_rows = rows_with_edges * 2 if accumulate else plan.n_rows
    nnz = plan.nnz
    b = rows_read * F * dsize + out_rows * F * 4 + (plan.n_rows + 1) * 4
    b += nnz * 8 + int(torch.unique(plan.eid).numel()) * 4
    return b, 2.0 * nnz * F


def k2_bytes_flops(plan, side, F, dsize):
    rows_read = int(torch.unique(side.ent_src_orig).numel())
    b = rows_read * F * dsize + plan.num_nodes * F * 4
    b += 4 * (side.n_tiles + 1 + 2 * side.n_blocks + 1
              + 2 * side.n_entries + 1 + 2 * side.n_in)
    if plan.row_of is not None:
        b += 4 * plan.num_nodes
    return b, 2.0 * side.n_entries * F


def time_k1(name, plan, x, w, acc, gen, library=None):
    """K1 on one plan against its plain version (accumulating into a random
    base when acc), with its ms, plain ms, bound and library ms."""
    dt = x.dtype
    base = torch.randn(plan.n_rows, x.shape[1], generator=gen, device="cuda")
    # accumulate mode adds into its output: the check starts both from
    # copies of one base, the timing adds into one buffer again and again
    # so that no copy is timed
    buf = base.clone() if acc else None

    def kern():
        return k1.segment_spmm_csr(x, w, plan, buf)

    def plain():
        return k1.segment_spmm_csr_plain(x, w, plan, buf)

    out = k1.segment_spmm_csr(x, w, plan, base.clone() if acc else None)
    ref = k1.segment_spmm_csr_plain(x, w, plan, base.clone() if acc else None)
    torch.cuda.synchronize()
    e, m = err_of(out, ref)
    tol = TOL_BF16 if dt == torch.bfloat16 else TOL_F32
    limit = check(f"k1 {name} {dt}", e, m, tol)
    dsize = 2 if dt == torch.bfloat16 else 4
    b, fl = k1_bytes_flops(plan, x.shape[1], dsize, acc)
    bms, by = bound(b, fl, "f32")
    if library is None:
        vals = w.index_select(0, plan.eid.long())
        library = library_spmm(plan.row.long(), plan.col.long(), vals,
                               plan.n_rows, x.shape[0], x)
    return dict(
        case=name, dtype=str(dt).split(".")[-1], nnz=plan.nnz, F=x.shape[1],
        max_abs_err=e, ref_max=m, limit=limit,
        ms=cuda_ms(kern), plain_ms=cuda_ms(plain),
        library_ms=cuda_ms(library) if library is not None else None,
        bound_ms=bms, bound_by=by, bytes=b, flops=fl,
    )


def time_k2(name, plan, x, w, transpose):
    dt = x.dtype
    side = plan.bwd if transpose else plan.fwd

    def kern():
        return k2.windowed_tile_spmm(x, w, plan, transpose)

    def plain():
        return k2.windowed_tile_spmm_plain(x, w, plan, transpose)

    out, ref = kern(), plain()
    torch.cuda.synchronize()
    e, m = err_of(out, ref)
    tol = TOL_BF16 if dt == torch.bfloat16 else TOL_F32
    limit = check(f"k2 {name} {dt}", e, m, tol)
    dsize = 2 if dt == torch.bfloat16 else 4
    b, fl = k2_bytes_flops(plan, side, x.shape[1], dsize)
    bms, by = bound(b, fl, "bf16_tensor" if dsize == 2 else "f32")
    vals = torch.zeros(side.n_entries, device="cuda").index_add_(
        0, side.edge_ent.long(), w.index_select(0, side.edge_eid.long())
    )
    lib = library_spmm(side.ent_dst_orig.long(), side.ent_src_orig.long(),
                       vals, plan.num_nodes, plan.num_nodes, x)
    return dict(
        case=name, dtype=str(dt).split(".")[-1], F=x.shape[1], max_abs_err=e,
        ref_max=m, limit=limit, ms=cuda_ms(kern), plain_ms=cuda_ms(plain),
        library_ms=cuda_ms(lib) if lib is not None else None,
        bound_ms=bms, bound_by=by, bytes=b, flops=fl,
    )


def kernel_k1(graph, w, F, gen):
    """K1 over all real edges (the composed path) and over the windowed
    residual in accumulate mode (the serving path's use), bf16 and f32."""
    res = {}
    cases = {"all_edges": (graph.csr, False), "residual": (graph.winplan.res, True)}
    for case, (plan, acc) in cases.items():
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(graph.n_nodes, F, generator=gen, device="cuda").to(dt)
            r = time_k1(case, plan, x, w, acc, gen)
            emit({"phase": "k1", **r})
            res[(case, r["dtype"])] = r
    return res


def kernel_k2(graph, w, F, gen):
    plan = graph.winplan
    res = {}
    emit({"phase": "k2_plan", "in_window_frac": plan.in_window_frac,
          "n_res": plan.n_res, "n_in": plan.fwd.n_in,
          "n_entries": plan.fwd.n_entries, "n_blocks": plan.fwd.n_blocks,
          "n_tiles": plan.fwd.n_tiles, "permuted": plan.row_of is not None})
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(graph.n_nodes, F, generator=gen, device="cuda").to(dt)
        r = time_k2("forward", plan, x, w, transpose=False)
        emit({"phase": "k2", **r})
        res[r["dtype"]] = r
    return res


def time_k3(graph, msg):
    """K3 over the graph's csr against its plain version (equal), with its
    ms, plain ms, bound and the scatter_reduce amax library call on the
    same rows."""
    plan = graph.csr
    F, dt = msg.shape[1], msg.dtype
    out = k3.segment_max_csr(msg, plan)
    ref = k3.segment_max_csr_plain(msg, plan)
    torch.cuda.synchronize()
    e, m = err_of(out, ref)
    if not torch.equal(out, ref):
        raise AssertionError(f"k3 F={F} {dt}: max abs err {e}, want equal")
    dsize = 2 if dt == torch.bfloat16 else 4
    rows_read = int(torch.unique(plan.eid).numel())
    b = rows_read * F * dsize + plan.n_rows * F * 4 + (plan.n_rows + 1 + plan.nnz) * 4
    bms, by = bound(b, float(plan.nnz) * F, "f32")
    rows = msg.index_select(0, plan.eid.long())
    idx = plan.row.long()[:, None].expand(-1, F)
    dst = torch.zeros(plan.n_rows, F, device="cuda", dtype=dt)

    def library():
        return dst.zero_().scatter_reduce_(0, idx, rows, "amax", include_self=False)

    try:
        library()
        torch.cuda.synchronize()
        lib_ms = cuda_ms(library)
    except (RuntimeError, NotImplementedError):
        lib_ms = None
    del rows, idx, dst
    return dict(
        case=f"csr F={F}", dtype=str(dt).split(".")[-1], nnz=plan.nnz, F=F,
        max_abs_err=e, ref_max=m, limit=0.0,
        ms=cuda_ms(lambda: k3.segment_max_csr(msg, plan)),
        plain_ms=cuda_ms(lambda: k3.segment_max_csr_plain(msg, plan)),
        library_ms=lib_ms, bound_ms=bms, bound_by=by, bytes=b,
        flops=float(plan.nnz) * F,
    )


def kernel_k3(graph, F_wide, F_narrow, gen):
    """K3 at the max-aggregation convs' shapes: F_wide = B*C (MRConv's
    layers, EdgeConv's layer 0), F_narrow = B*final (EdgeConv's layer 1);
    bf16 and f32 edge rows."""
    res = {}
    for F in (F_wide, F_narrow):
        for dt in (torch.bfloat16, torch.float32):
            msg = torch.randn(graph.num_padded_edges, F, generator=gen,
                              device="cuda").to(dt)
            r = time_k3(graph, msg)
            emit({"phase": "k3", **r})
            res[(F, r["dtype"])] = r
            del msg
    return res


def kernel_bwd(graph, ctx, w, F, F_gather, gen):
    """The backward forms at the training path's shapes: K1 over csc (the
    composed backward, all edges), over tres and res_csc (accumulating into
    K2's output), K1 as the gather_rows backward (unit weights, F_gather
    wide), K1 as the backward of the edge gathers x[senders] and
    x[receivers] (unit weights, F wide, the max-aggregation convs' path),
    and K2 on the transpose side; bf16 and f32."""
    plan = graph.winplan
    emit({"phase": "k2_bwd_plan", "n_in": plan.bwd.n_in,
          "n_entries": plan.bwd.n_entries, "n_blocks": plan.bwd.n_blocks,
          "n_tiles": plan.bwd.n_tiles,
          "blocks_per_tile": plan.bwd.n_blocks / plan.bwd.n_tiles,
          "n_tres": plan.n_tres, "n_res": plan.n_res})
    r1, r2 = {}, {}
    G = ctx.num_pca_rows
    ones = torch.ones(G, device="cuda")
    for dt in (torch.bfloat16, torch.float32):
        d = str(dt).split(".")[-1]
        for case, p, acc in (("csc", graph.csc, False), ("tres", plan.tres, True),
                             ("res_csc", plan.res_csc, True)):
            x = torch.randn(graph.n_nodes, F, generator=gen, device="cuda").to(dt)
            r1[(case, d)] = time_k1(case, p, x, w, acc, gen)
            emit({"phase": "k1_bwd", **r1[(case, d)]})
        g = torch.randn(G, F_gather, generator=gen, device="cuda").to(dt)
        idx = ctx.pca_rows
        dst = torch.zeros(graph.n_nodes, F_gather, device="cuda", dtype=dt)
        r1[("gather_rows_bwd", d)] = time_k1(
            "gather_rows_bwd", ctx.pca_gather, g, ones, False, gen,
            library=lambda: dst.zero_().index_add_(0, idx, g),
        )
        emit({"phase": "k1_bwd", **r1[("gather_rows_bwd", d)]})
        E = graph.num_padded_edges
        g = torch.randn(E, F, generator=gen, device="cuda").to(dt)
        ones_e = torch.ones(E, device="cuda")
        dst = torch.zeros(graph.n_nodes, F, device="cuda", dtype=dt)
        for case, p, ids in (("src_gather", graph.src_gather, graph.senders),
                             ("dst_gather", graph.dst_gather, graph.receivers)):
            r1[(case, d)] = time_k1(
                case, p, g, ones_e, False, gen,
                library=lambda ids=ids: dst.zero_().index_add_(0, ids, g),
            )
            emit({"phase": "k1_bwd", **r1[(case, d)]})
        del g, dst
        x = torch.randn(graph.n_nodes, F, generator=gen, device="cuda").to(dt)
        r2[d] = time_k2("transpose", plan, x, w, transpose=True)
        emit({"phase": "k2_bwd", **r2[d]})
    return r1, r2


def launch_counts():
    return {k.name: k.launches for k in build.REGISTRY.values()}


def zero_launches():
    for k in build.REGISTRY.values():
        k.launches = 0


def kernel_rows(prof, n):
    """(name, device ms, calls) per kernel and per one of the n profiled
    iterations, largest first."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        # kernels only: an aten op's self device time repeats its kernels',
        # and a user annotation's (Optimizer.step) spans them
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt > 0:
            rows.append((ev.key[:90], dt / 1e3 / n, ev.count // n))
    return sorted(rows, key=lambda r: -r[1])


def profile_serve(model, graph, ctx, batch):
    """profile_eval on one full batch, then the windowed path against the
    composed one (K1 over all edges) end to end, in turns, with each
    path's kernel launches counted; serve_paths' gap share is the part of
    the windowed eval_step (CUDA events) with no kernel running."""
    busy = profile_eval(model, ctx, batch, "profile")

    composed = dataclasses.replace(
        ctx, graph=dataclasses.replace(graph, winplan=None)
    )

    def step_ms(c):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        eval_step(model, batch, c)
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    eval_step(model, batch, composed)
    t = {"windowed": [], "composed": []}
    launches = {p: {k: 0 for k in launch_counts()} for p in t}
    for _ in range(5):
        for name, c in (("windowed", ctx), ("composed", composed),
                        ("composed", composed), ("windowed", ctx)):
            zero_launches()
            t[name].append(step_ms(c))
            for k, v in launch_counts().items():
                launches[name][k] += v
    med = {k: float(np.median(v)) for k, v in t.items()}
    emit({"phase": "serve_paths", "ms_per_batch_median": med, "turns": 10,
          "launches": launches, "gap_share": 1 - busy / med["windowed"]})
    n = len(t["composed"])
    k3_none = {k3.KERNEL.name: 0, k4.name: 0}
    if (launches["composed"] != {k1.KERNEL.name: 2 * n, k2.KERNEL.name: 0, **k3_none}
            or launches["windowed"] != {k1.KERNEL.name: 2 * n,
                                        k2.KERNEL.name: 2 * n, **k3_none}):
        raise AssertionError(f"serve_paths launch counts {launches}")


def patients(n_nodes, n=N_PATIENTS, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, n_nodes).astype(np.float32)
    Y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, n)]
    ages = (rng.rand(n) * 80).astype(np.float32)
    return X, Y, ages


def forward_vs_plain(phase, models, ctx, batch):
    """Kernels vs plain versions through the whole forward on the card, for
    each (trunk name, image tolerance, model factory) in turn, one model
    alive at a time."""
    for name, tol_img, make in models:
        m = make()
        with torch.no_grad():
            m.eval()
            pk, ik = m(batch, ctx)
            with spmm.plain_versions():
                pp, ip = m(batch, ctx)
        torch.cuda.synchronize()
        e = float((pk - pp).abs().max())
        ie, im = err_of(ik, ip)
        finite = bool(torch.isfinite(pk).all() and torch.isfinite(ik).all())
        sums = float((pk.sum(-1) - 1).abs().max())
        ok = (finite and sums < 1e-5 and e <= TOL_PROB and im > 0
              and ie <= tol_img * im)
        emit({"phase": phase, "trunk": name, "max_abs_err_prob": e,
              "tol_prob": TOL_PROB, "max_abs_err_image": ie, "image_max": im,
              "tol_image": tol_img, "finite": finite,
              "max_row_sum_err": sums, "shape": list(pk.shape), "ok": ok})
        if not ok:
            raise AssertionError(f"{phase} {name} mismatch")
        del m, pk, ik, pp, ip


def slice_checks(model, graph, ctx, batch):
    """The sage forward with kernels against plain versions on the card,
    and a small fold on the card against the CPU."""
    f32 = model.cfg.replace(compute_dtype=None, spmm_bf16=False)
    forward_vs_plain("slice", (
        ("bf16", TOL_IMAGE_BF16, lambda: model),
        ("f32", TOL_IMAGE_F32, lambda: MultilevelGNN(
            f32, graph.n_nodes, ctx.num_pca_rows, device="cuda", seed=0)),
    ), ctx, batch)
    # a small fold on the card (kernels) against the same fold on the CPU
    # (plain versions), f32 trunk
    res = {}
    for dev in ("cuda", "cpu"):
        _, m, _, c, b = make_gbm_scale_setup(
            node_num=300, n_pathways=12, batch=8, gene_rows=900,
            topology="cohort", windowed=True, device=dev,
        )
        res[dev] = [t.float().cpu() for t in eval_step(m, b, c)]
    e = float((res["cuda"][0] - res["cpu"][0]).abs().max())
    ok = e <= TOL_PROB_CPU and bool(torch.isfinite(res["cuda"][0]).all())
    emit({"phase": "slice_small_vs_cpu", "max_abs_err_prob": e,
          "tol": TOL_PROB_CPU, "ok": ok})
    if not ok:
        raise AssertionError("small fold: card vs CPU mismatch")


def grads_of(model, batch, ctx, cw, seed):
    """One training-mode loss's gradients, dropout masks from ``seed``."""
    model.train()
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    loss, _ = make_loss_fn(model.cfg)(model, batch, ctx, cw, gen)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}


def train_grad_checks(models, ctx, batch, cw, phase="train_grad", tol=TOL_GRAD):
    """One step's gradients with kernels against the same step with plain
    versions (forward and backward), same params, same dropout masks.
    models: (trunk name, model) pairs."""
    for name, m in models:
        lk, gk = grads_of(m, batch, ctx, cw, seed=5)
        with spmm.plain_versions():
            lp, gp = grads_of(m, batch, ctx, cw, seed=5)
        torch.cuda.synchronize()
        rel = {}
        for n in gk:
            gmax = float(gp[n].abs().max())
            rel[n] = float((gk[n] - gp[n]).abs().max()) / max(gmax, 1e-30)
        worst = max(rel.values())
        finite = all(bool(torch.isfinite(g).all()) for g in gk.values())
        ok = finite and worst <= tol[name]
        emit({"phase": phase, "trunk": name, "loss": lk,
              "loss_plain": lp, "max_rel_err": worst, "tol": tol[name],
              "rel_err_by_param": rel, "finite": finite, "ok": ok})
        if not ok:
            raise AssertionError(f"{phase} {name}: kernels vs plain {worst}")
        m.zero_grad(set_to_none=True)


def train_phase(cfg, ctx, model_seed_state):
    """The training path at GBM scale: run_fold for 3 epochs, counted."""
    X, Y, ages = patients(ctx.graph.n_nodes, n=N_TRAIN_PATIENTS, seed=2)
    tr, va, te = np.arange(192), np.arange(192, 224), np.arange(224, 256)
    cw = class_weight(Y, tr, cfg.weight_power)
    plan = ctx.graph.winplan

    def fold_model():
        m = MultilevelGNN(cfg, ctx.graph.n_nodes, ctx.num_pca_rows,
                          device="cuda", seed=0)
        m.load_state_dict(model_seed_state)
        return m

    model = fold_model()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    zero_launches()
    res = run_fold(cfg, ctx, X, Y, ages, tr, va, te, cw, [1, 2, 3], model=model)
    torch.cuda.synchronize()
    launches = launch_counts()
    n_steps = len(res.step_losses)
    n_eval = 3 * 2  # valid + test, one batch each, per epoch
    k1_step = 2 * (plan.n_res > 0) + 2 * ((plan.n_tres > 0) + (plan.n_res > 0)) + 1
    want = {k1.KERNEL.name: n_steps * k1_step + n_eval * 2 * (plan.n_res > 0),
            k2.KERNEL.name: n_steps * 4 + n_eval * 2, k3.KERNEL.name: 0, k4.name: 0}
    moved = max(float((p.detach() - before[n]).abs().max())
                for n, p in model.named_parameters())
    valid_auc = [v[0] for v in res.epoch_valid]
    step_ms = float(np.median(res.step_ms))
    # epoch 1 again from the same seeds
    again = run_fold(cfg.replace(epochs=1), ctx, X, Y, ages, tr, va, te, cw,
                     [1], model=fold_model())
    replay = float(np.max(np.abs(np.array(again.step_losses[:3])
                                 - np.array(res.step_losses[:3]))))
    ok = (launches == want and n_steps == 18
          and bool(np.isfinite(res.step_losses).all()) and moved > 0
          and replay <= TOL_REPLAY)
    emit({"phase": "train", "epochs": 3, "steps": n_steps,
          "ms_per_step_median": step_ms, "step_ms": res.step_ms,
          "host_s_per_epoch": res.epoch_times, "launches": launches,
          "launches_expected": want,
          "launches_per_step_expected": {k1.KERNEL.name: k1_step, k2.KERNEL.name: 4,
                                         k3.KERNEL.name: 0, k4.name: 0},
          "losses": res.step_losses, "max_param_move": moved,
          "valid_auc": valid_auc, "valid_loss": [v[2] for v in res.epoch_valid],
          "test_auc_at_check": {
              e: float(M.roc_auc(res.y_true, s))
              for e, s in res.epoch_pred_by_epoch.items()},
          "replay_max_abs_loss_diff": replay, "replay_tol": TOL_REPLAY,
          "ok": ok})
    if not ok:
        raise AssertionError("train phase failed")
    return dict(per_step={k1.KERNEL.name: k1_step, k2.KERNEL.name: 4,
                          k3.KERNEL.name: 0, k4.name: 0},
                batch=next(iter_batches(X, Y, ages, tr, cfg.batch_size, "cuda")),
                model=model, cw=torch.as_tensor(cw, dtype=torch.float32, device="cuda"))


def profile_train(model, ctx, batch, cw, want_per_step, n_timed=10, n_prof=3,
                  phase="profile_train"):
    """One batch and one optimizer: n_timed train steps timed with CUDA
    events and their kernel launches counted (per step), then n_prof steps
    under the profiler for device time by kernel.  The gap share is the
    part of the median timed step with no kernel running."""
    from torch.profiler import ProfilerActivity, profile

    opt = make_optimizer(model, model.cfg, 6)
    gen = torch.Generator(device="cuda").manual_seed(9)
    for _ in range(2):
        train_step(model, opt, batch, ctx, cw, gen)
    torch.cuda.synchronize()
    zero_launches()
    events = []
    for _ in range(n_timed):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        train_step(model, opt, batch, ctx, cw, gen)
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in events]
    per_step = {k: v / n_timed for k, v in launch_counts().items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            train_step(model, opt, batch, ctx, cw, gen)
        torch.cuda.synchronize()
    rows = kernel_rows(prof, n_prof)
    busy = sum(r[1] for r in rows)
    step_ms = float(np.median(ms))
    ok = per_step == want_per_step
    emit({"phase": phase, "kernel_ms_per_step": busy,
          "kernels_per_step": sum(r[2] for r in rows),
          "step_ms": ms, "step_ms_median": step_ms,
          "gap_share": 1 - busy / step_ms,
          "launches_per_step": per_step, "launches_per_step_expected": want_per_step,
          "top": [{"name": n, "ms": t, "calls": c} for n, t, c in rows[:16]],
          "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: launches per step {per_step}, want {want_per_step}")
    return per_step


def profile_eval(model, ctx, batch, phase, n_timed=10, n_prof=3):
    """Device time by kernel over n_prof eval steps of one full batch, and
    the share of the median CUDA-event-timed eval step (n_timed of them)
    with no kernel running."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        eval_step(model, batch, ctx)
    torch.cuda.synchronize()
    events = []
    for _ in range(n_timed):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        eval_step(model, batch, ctx)
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    step_ms = float(np.median([a.elapsed_time(b) for a, b in events]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            eval_step(model, batch, ctx)
        torch.cuda.synchronize()
    rows = kernel_rows(prof, n_prof)
    busy = sum(r[1] for r in rows)
    emit({"phase": phase, "kernel_ms_per_batch": busy,
          "kernels_per_batch": sum(r[2] for r in rows),
          "eval_step_ms_median": step_ms, "gap_share": 1 - busy / step_ms,
          "top": [{"name": n, "ms": t, "calls": c} for n, t, c in rows[:14]]})
    return busy


def serve_conv(conv, model, ctx, n_batches):
    """The max-aggregation serving path: predict_patients over N_PATIENTS,
    counted: K3 twice a batch (one per layer), no K1 or K2."""
    X, Y, ages = patients(ctx.graph.n_nodes)
    idx = np.arange(N_PATIENTS)
    predict_patients(model, ctx, X, Y, ages, idx)  # warm-up, not counted
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    res = predict_patients(model, ctx, X, Y, ages, idx)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    want = {k1.KERNEL.name: 0, k2.KERNEL.name: 0, k3.KERNEL.name: 2 * n_batches,
            k4.name: 0}
    prob = np.asarray(res["prob"])
    ok = (len(prob) == N_PATIENTS and bool(np.isfinite(prob).all())
          and bool(((prob >= 0) & (prob <= 1)).all())
          and np.isfinite(res["loss"]) and launches == want)
    emit({"phase": f"serve_{conv}", "batches": n_batches, "patients": N_PATIENTS,
          "ms_per_batch": dt * 1e3 / n_batches, "launches": launches,
          "launches_expected": want, "auc": res["auc"], "acc": res["acc"],
          "loss": res["loss"], "ok": ok})
    if not ok:
        raise AssertionError(f"serve_{conv} phase failed")
    return launches


def train_conv(conv, cfg, ctx):
    """run_fold with a max-aggregation conv for CONV_EPOCHS epochs, counted;
    then profile_train on one batch, which reads the launches per step from
    the counters: K3 2, K1 5, K2 0."""
    X, Y, ages = patients(ctx.graph.n_nodes, n=N_TRAIN_PATIENTS, seed=2)
    tr, va, te = np.arange(192), np.arange(192, 224), np.arange(224, 256)
    cw = class_weight(Y, tr, cfg.weight_power)
    model = MultilevelGNN(cfg, ctx.graph.n_nodes, ctx.num_pca_rows,
                          device="cuda", seed=0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    res = run_fold(cfg, ctx, X, Y, ages, tr, va, te, cw,
                   list(range(1, CONV_EPOCHS + 1)), model=model)
    torch.cuda.synchronize()
    launches = launch_counts()
    n_steps = len(res.step_losses)
    bs = cfg.batch_size
    n_eval = CONV_EPOCHS * (-(-len(va) // bs) + -(-len(te) // bs))
    want = {k1.KERNEL.name: 5 * n_steps, k2.KERNEL.name: 0,
            k3.KERNEL.name: 2 * (n_steps + n_eval), k4.name: 0}
    moved = max(float((p.detach() - before[n]).abs().max())
                for n, p in model.named_parameters())
    losses = np.asarray(res.step_losses)
    ok = (launches == want and n_steps == len(tr) // bs * CONV_EPOCHS
          and bool(np.isfinite(losses).all()) and len(set(res.step_losses)) > 1
          and moved > 0)
    emit({"phase": f"train_{conv}", "epochs": CONV_EPOCHS, "steps": n_steps,
          "ms_per_step_median": float(np.median(res.step_ms)),
          "step_ms": res.step_ms, "host_s_per_epoch": res.epoch_times,
          "launches": launches, "launches_expected": want,
          "losses": res.step_losses, "max_param_move": moved,
          "valid_auc": [v[0] for v in res.epoch_valid],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "ok": ok})
    if not ok:
        raise AssertionError(f"train_{conv} phase failed")
    batch = next(iter_batches(X, Y, ages, tr, cfg.batch_size, "cuda"))
    cwt = torch.as_tensor(cw, dtype=torch.float32, device="cuda")
    want_step = {k1.KERNEL.name: 5, k2.KERNEL.name: 0, k3.KERNEL.name: 2, k4.name: 0}
    return profile_train(model, ctx, batch, cwt, want_step,
                         phase=f"profile_train_{conv}")


def conv_paths(conv, cfg, ctx, batch, n_batches):
    """Every phase of one max-aggregation conv on the GBM fold; cfg is the
    training config (gbm.yaml's optimizer and dropouts, bf16 trunk)."""
    ccfg = cfg.replace(gnn_name=conv)
    n, G = ctx.graph.n_nodes, ctx.num_pca_rows

    def make(c):
        return lambda: MultilevelGNN(c, n, G, device="cuda", seed=0)

    f32 = ccfg.replace(compute_dtype=None, spmm_bf16=False)
    model = make(ccfg)()
    serve = serve_conv(conv, model, ctx, n_batches)
    profile_eval(model, ctx, batch, f"profile_{conv}")
    forward_vs_plain(f"slice_{conv}", (("bf16", TOL_IMAGE_F32, lambda: model),
                                       ("f32", TOL_IMAGE_F32, make(f32))), ctx, batch)
    cw = torch.tensor([1.0, 1.5], device="cuda")
    train_grad_checks((("bf16", model),), ctx, batch, cw,
                      phase=f"train_grad_{conv}", tol=TOL_GRAD_MAX)
    del model
    m32 = make(f32)()
    train_grad_checks((("f32", m32),), ctx, batch, cw,
                      phase=f"train_grad_{conv}", tol=TOL_GRAD_MAX)
    del m32
    per_step = train_conv(conv, ccfg.replace(epochs=CONV_EPOCHS), ctx)
    torch.cuda.empty_cache()
    return serve, per_step


TOL_K4 = 1e-5  # times max(1, max|plain|): both sum the same exact values in f32
TOL_PROTOCOL = 1e-4  # a small protocol's fold test scores, card against CPU
# The reference-scale cohort written, loaded and trained (bench.py:513-516's
# shape): 400 patients, 146 pathways of 38 genes sharing 3, 60,000 GRN edges.
REF_COHORT = dict(n_patients=400, n_pathways=146, genes_per_pathway=38, overlap=3,
                  n_edges=60000, seed=2)
SMALL_COHORT = dict(n_patients=60, n_pathways=8, seed=2)
GBM_YAML = str(Path(__file__).resolve().parent / "configs" / "gbm.yaml")


def time_k4(case, data, plan, permuted):
    """K4 on one plan against its plain version, with its ms, plain ms,
    bound and torch.segment_reduce over the same kept rows."""
    dt = data.dtype
    if permuted:
        def kern():
            return k1.segment_sum_by(data, plan)
    else:
        def kern():
            return k1.sorted_segment_sum(data, plan)

    def plain():
        return k1.sorted_segment_sum_plain(data, plan, permuted=permuted)

    out, ref = kern(), plain()
    torch.cuda.synchronize()
    e, m = err_of(out, ref)
    limit = check(f"k4 {case} {dt}", e, m, TOL_K4)
    dsize = 2 if dt == torch.bfloat16 else 4
    B = data.shape[0] if data.dim() == 3 else 1
    C = data.shape[-1]
    b = (B * plan.n_kept * C * dsize + B * plan.num_segments * C * 4
         + (plan.num_segments + 1) * 4 + (plan.n_kept * 4 if permuted else 0))
    bms, by = bound(b, float(B * plan.n_kept * C), "f32")
    rows = data
    if permuted and plan.perm is not None:
        rows = data.index_select(-2, plan.perm[: plan.n_kept].long())
    rows = rows.narrow(-2, 0, plan.n_kept).contiguous()
    lengths = (plan.rowptr[1:] - plan.rowptr[:-1]).long()
    axis = rows.dim() - 2
    if axis:
        lengths = lengths.expand(B, -1).contiguous()

    def library():
        return torch.segment_reduce(rows, "sum", lengths=lengths, axis=axis)

    try:
        lib = library()
        torch.cuda.synchronize()
        lib_err = float((lib.float() - ref).abs().max())
        lib_ms = cuda_ms(library)
    except (RuntimeError, NotImplementedError, TypeError):
        lib_err, lib_ms = None, None
    return dict(
        case=case, dtype=str(dt).split(".")[-1], shape=list(data.shape),
        n_kept=plan.n_kept, segments=plan.num_segments, max_abs_err=e, ref_max=m,
        limit=limit, ms=cuda_ms(kern), plain_ms=cuda_ms(plain), library_ms=lib_ms,
        library_max_abs_err=lib_err, bound_ms=bms, bound_by=by, bytes=b,
        flops=float(B * plan.n_kept * C),
    )


def kernel_k4(graph, B, C, F, gen):
    """K4 at the GBM fold's sorted receivers: K4a on (B, E, C) rows, K4b on
    (E, F) rows, bf16 and f32; then segment_sum_by through a non-identity
    perm (the senders' order) with 10% of the rows masked out."""
    recv = graph.receivers.cpu().numpy()
    mask = graph.edge_mask.cpu().numpy()
    plan = k1.SortedPlan.build(recv, graph.n_nodes, mask=mask).to("cuda")
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        for case, shape in (("K4a", (B, plan.n_ids, C)), ("K4b", (plan.n_ids, F))):
            data = torch.randn(*shape, generator=gen, device="cuda").to(dt)
            r = time_k4(case, data, plan, permuted=False)
            emit({"phase": "k4", **r})
            res[(case, r["dtype"])] = r
            del data
    rng = np.random.RandomState(4)
    send = graph.senders.cpu().numpy()
    keep = mask & (rng.rand(len(send)) > 0.1)
    pplan = k1.SortedPlan.build(send, graph.n_nodes, mask=keep).to("cuda")
    data = torch.randn(B, pplan.n_ids, C, generator=gen, device="cuda").to(torch.bfloat16)
    r = time_k4("segment_sum_by", data, pplan, permuted=True)
    emit({"phase": "k4", "perm": pplan.perm is not None, **r})
    res[("segment_sum_by", r["dtype"])] = r
    if pplan.perm is None or pplan.n_kept >= pplan.n_ids:
        raise AssertionError("k4 segment_sum_by case has no perm or no dropped rows")
    return res


def cohort_phase(root, device="cuda"):
    """Reference-format files at reference scale, loaded with gbm.yaml, and
    fold 0's derivation, timed by stage."""
    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.data import native
    from multilevel_gnn_tpu_torch.data.loaders import load_cohort_from_files
    from multilevel_gnn_tpu_torch.data.synthetic import write_reference_format
    from multilevel_gnn_tpu_torch.train.driver import stratified_kfold

    t0 = time.perf_counter()
    write_reference_format(root, cancer_type="gbm", **REF_COHORT)
    t_write = time.perf_counter() - t0
    cfg = Config.from_yaml(GBM_YAML)
    t0 = time.perf_counter()
    cohort = load_cohort_from_files(
        f"{root}/gbm/raw_mrna.csv", f"{root}/gbm/raw_cnv.csv",
        f"{root}/gbm/raw_methylation.csv", f"{root}/gbm/clinical.pkl",
        f"{root}/kegg.csv", f"{root}/pathways.txt", f"{root}/gbm/grn_edges.tsv", cfg,
    )
    t_load = time.perf_counter() - t0
    labels = cohort.labels()
    tune, _ = stratified_kfold(labels, 5, cfg.split_shaffle, cfg.split_seed)[0]
    tr = tune[stratified_kfold(labels[tune], 5, cfg.split_shaffle, cfg.split_seed)[0][0]]
    t0 = time.perf_counter()
    fold = cohort.fold(tr, 0, device=device)
    sync(device)
    t_fold = time.perf_counter() - t0
    # the MI estimator again on the same rows (library built by now), at
    # gbm.yaml's k = 7 and kirc / lgg's k = 15
    pos = {p: i for i, p in enumerate(cohort.pca_patients)}
    x = cohort.raw_datas[[pos[cohort.patients[i]] for i in tr]].astype(np.float32)
    mi_s = {}
    for k in (7, 15):
        t0 = time.perf_counter()
        native.mi_classif(x, labels[tr], n_neighbors=k, random_state=cfg.random_state)
        mi_s[k] = time.perf_counter() - t0
    g = fold.ctx.graph
    ok = bool(cohort.num_nodes > 15000 and cohort.n_pathways == 146
              and 0 < fold.info_mask.mean() < 1 and fold.edge_count > cohort.num_nodes
              and np.isfinite(fold.pca_seed).all() and np.abs(fold.pca_seed).max() > 0)
    emit({"phase": "cohort", "write_s": t_write, "load_s": t_load, "fold_s": t_fold,
          "fold_stage_s": fold.seconds, "mi_s_by_k": mi_s,
          "mi_features": x.shape[1], "patients": len(cohort.patients),
          "pca_patients": len(cohort.pca_patients), "train_patients": len(tr),
          "node_slots": cohort.num_nodes, "pathways": cohort.n_pathways,
          "pca_rows": cohort.num_pca_rows, "mask_on_share": float(fold.info_mask.mean()),
          "real_edges": fold.edge_count, "padded_edges": g.num_padded_edges,
          "windowed": g.winplan is not None,
          "windowed_min_edges": cfg.windowed_min_edges, "ok": ok})
    if not ok:
        raise AssertionError("cohort phase failed")


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _spy_folds():
    """Record each run_fold's FoldResult inside run_experiment."""
    from multilevel_gnn_tpu_torch.train import driver

    real, out = driver.run_fold, []

    def spy(*a, **k):
        out.append(real(*a, **k))
        return out[-1]

    driver.run_fold = spy
    return out, lambda: setattr(driver, "run_fold", real)


def experiment_phase(root, device="cuda"):
    """The train CLI's main on the reference-scale directory: 1 run x 5
    folds x 5 epochs at gbm.yaml's widths, bf16 trunk, on the card, counted;
    then a small protocol (f32, dropout off, 2 epochs) on the card and on the
    CPU, fold test scores compared."""
    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.data.synthetic import make_synthetic_cohort
    from multilevel_gnn_tpu_torch.train import cli, driver

    sync(device)
    zero_launches()
    t0 = time.perf_counter()
    res = cli.main(["--config", GBM_YAML, "--data-dir", root, "--device", device,
                    "--set", "num_run=1", "epochs=5"])
    sync(device)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    folds = res["folds"]
    want_k2 = any(f["windowed"] for f in folds)
    auc, acc = res["auc"][5], res["acc"][5]
    ok = bool(len(folds) == 5 and launches[k1.KERNEL.name] > 0
          and (launches[k2.KERNEL.name] > 0) == want_k2
          and launches[k3.KERNEL.name] == 0 and launches[k4.name] == 0
          and 0.0 <= auc <= 1.0 and 0.0 <= acc <= 1.0)
    emit({"phase": "experiment", "wall_s": wall, "cli_wall_time_s": res["wall_time_s"],
          "fold_setup_s": [f["setup_s"] for f in folds],
          "fold_stage_s": [f["setup_stage_s"] for f in folds],
          "edges": [f["edges"] for f in folds], "windowed": [f["windowed"] for f in folds],
          "ms_per_step_median": [f["step_ms_median"] for f in folds],
          "host_s_per_epoch": [f["epoch_s"] for f in folds],
          "launches": launches, "pooled_auc_5": auc, "pooled_acc_5": acc, "ok": ok})
    if not ok:
        raise AssertionError("experiment phase failed")

    cfg = Config.from_yaml(GBM_YAML).replace(
        num_run=1, epochs=2, compute_dtype=None, spmm_bf16=False, feature_drop=False,
        head_drop_rate=0.0, gnn_dropout=0.0)
    scores = {}
    for dev in (device, "cpu"):
        cohort = make_synthetic_cohort(cfg, **SMALL_COHORT)
        rec, undo = _spy_folds()
        try:
            out = driver.run_experiment(cfg, cohort, device=dev)
        finally:
            undo()
        scores[dev] = (rec, out)
    errs = [max(float(np.abs(a.epoch_pred[2] - b.epoch_pred[2]).max()),
                float(np.abs(a.epoch_pred_by_epoch[2] - b.epoch_pred_by_epoch[2]).max()))
            for a, b in zip(scores[device][0], scores["cpu"][0])]
    ok = len(errs) == 5 and max(errs) <= TOL_PROTOCOL
    emit({"phase": "experiment_small_vs_cpu", "fold_max_abs_err": errs, "tol": TOL_PROTOCOL,
          "pooled_auc_cuda": scores[device][1]["auc"][2],
          "pooled_auc_cpu": scores["cpu"][1]["auc"][2], "ok": ok})
    if not ok:
        raise AssertionError("small protocol: card vs CPU mismatch")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_tf32": False, "cudnn_tf32": False})

    t0 = time.perf_counter()
    times = build.build_all()
    regs = {
        k.name: [ln.strip() for ln in k.ptxas_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        for k in build.REGISTRY.values()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": times, "ptxas": regs})

    t0 = time.perf_counter()
    cfg, model, graph, ctx, batch = make_gbm_scale_setup(
        topology="cohort", windowed=True, batch=32,
        compute_dtype="bfloat16", spmm_bf16=True, device="cuda",
    )
    torch.cuda.synchronize()
    F = cfg.batch_size * cfg.node_embedding_dim  # B*C at the SpMMs
    emit({"phase": "setup", "seconds": time.perf_counter() - t0,
          "n_nodes": graph.n_nodes, "n_edges": graph.n_edges, "F": F,
          "batch": cfg.batch_size, "windowed": graph.winplan is not None})
    if graph.winplan is None:
        raise AssertionError("the GBM cohort fold did not engage the windowed path")

    gen = torch.Generator(device="cuda").manual_seed(0)
    w = spmm.edge_weights(graph, "mean", graph.edge_attr)
    r1 = kernel_k1(graph, w, F, gen)
    r2 = kernel_k2(graph, w, F, gen)
    r3 = kernel_k3(graph, F, cfg.batch_size * cfg.final_channels, gen)

    X, Y, ages = patients(graph.n_nodes)
    idx = np.arange(N_PATIENTS)
    predict_patients(model, ctx, X, Y, ages, idx)  # warm-up, not counted
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    res = predict_patients(model, ctx, X, Y, ages, idx)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    n_batches = -(-N_PATIENTS // cfg.batch_size)
    prob = np.asarray(res["prob"])
    ok = (
        len(prob) == N_PATIENTS and bool(np.isfinite(prob).all())
        and bool(((prob >= 0) & (prob <= 1)).all())
        and np.isfinite(res["loss"]) and launches[k1.KERNEL.name] > 0
        and launches[k2.KERNEL.name] > 0 and launches[k3.KERNEL.name] == 0
        and launches[k4.name] == 0
    )
    emit({"phase": "serve", "batches": n_batches, "patients": N_PATIENTS,
          "ms_per_batch": dt * 1e3 / n_batches, "launches": launches,
          "auc": res["auc"], "acc": res["acc"], "loss": res["loss"], "ok": ok})
    if not ok:
        raise AssertionError("serve phase failed")

    init_state = {k: v.clone() for k, v in model.state_dict().items()}
    slice_checks(model, graph, ctx, batch)
    profile_serve(model, graph, ctx, batch)

    # ---- the training path
    b1, b2 = kernel_bwd(graph, ctx, w, F, cfg.batch_size * cfg.final_channels, gen)
    rng = np.random.RandomState(3)
    pca_seed = (rng.randn(ctx.num_pca_rows, cfg.pca_dim) * 0.05).astype(np.float32)
    ctx = dataclasses.replace(ctx, pca_seed=torch.as_tensor(pca_seed, device="cuda"))
    # gbm.yaml's optimizer (Adam, lr 1e-4, no clip, no StepLR, no wd) and
    # dropouts (feature_drop 0.25, head dropout 0.5), 3 epochs
    tcfg = cfg.replace(epochs=3, init_with_pca=True)
    f32_model = MultilevelGNN(
        tcfg.replace(compute_dtype=None, spmm_bf16=False),
        graph.n_nodes, ctx.num_pca_rows, device="cuda", seed=0,
    )
    train_grad_checks((("bf16", model), ("f32", f32_model)), ctx, batch,
                      torch.tensor([1.0, 1.5], device="cuda"))
    del f32_model
    tr = train_phase(tcfg, ctx, init_state)
    train_per_step = profile_train(tr["model"], ctx, tr["batch"], tr["cw"],
                                   tr["per_step"])
    del tr
    torch.cuda.empty_cache()

    # ---- the max-aggregation convs (MRConv, EdgeConv) on the same fold
    paths = {"serve_sage": launches}
    per_step = {"sage": train_per_step}
    for conv in ("mr", "edge"):
        paths[f"serve_{conv}"], per_step[conv] = conv_paths(
            conv, tcfg, ctx, batch, n_batches)

    # ---- K4 (sorted segment-sum): no path of the package reaches it
    r4 = kernel_k4(graph, cfg.batch_size, cfg.node_embedding_dim, F, gen)
    del model, ctx, batch
    torch.cuda.empty_cache()

    # ---- the protocol from reference-format files
    with tempfile.TemporaryDirectory() as root:
        cohort_phase(root)
        paths["experiment"] = experiment_phase(root)

    main_k1 = r1[("residual", "bfloat16")]
    main_k2 = r2["bfloat16"]
    main_k3 = r3[(F, "bfloat16")]
    main_k4 = r4[("K4a", "bfloat16")]
    backward = {
        k1.KERNEL.name: [b1[(c, "bfloat16")] for c in
                         ("csc", "tres", "res_csc", "gather_rows_bwd",
                          "src_gather", "dst_gather")],
        k2.KERNEL.name: [b2["bfloat16"]],
        k3.KERNEL.name: [],  # its backward is torch's compare and where
        k4.name: [],
    }
    # K4's other forms: K4b, f32, and segment_sum_by through perm
    forms = {k4.name: [r4[key] for key in (("K4b", "bfloat16"), ("K4a", "float32"),
                                           ("K4b", "float32"),
                                           ("segment_sum_by", "bfloat16"))]}
    # launches: the count on the kernel's first serving path (sage for K1
    # and K2, mr for K3); every path's count is in launches_by_path
    first = {k1.KERNEL.name: "serve_sage", k2.KERNEL.name: "serve_sage",
             k3.KERNEL.name: "serve_mr", k4.name: "serve_sage"}
    kernels = []
    for k, r in ((k1.KERNEL, main_k1), (k2.KERNEL, main_k2), (k3.KERNEL, main_k3),
                 (k4, main_k4)):
        kernels.append({
            "name": k.name, "route": k.route, "source": k.source_rel,
            "replaces": k.replaces, "launches": paths[first[k.name]][k.name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "train_launches_per_step": per_step[
                "sage" if first[k.name] == "serve_sage" else "mr"][k.name],
            "launches_by_path": {p: c[k.name] for p, c in paths.items()},
            "train_launches_per_step_by_path": {
                p: c[k.name] for p, c in per_step.items()},
            "backward": [
                {key: b[key] for key in ("case", "max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms")}
                for b in backward[k.name]
            ],
            "forms": [
                {key: b[key] for key in ("case", "dtype", "shape", "max_abs_err", "ms",
                                         "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for b in forms.get(k.name, [])
            ],
        })
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
