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
           plain version (max abs error, stated tolerance; device ms per
           call of the kernel, the plain version and the torch.sparse.mm
           library call, from the profiler, and the kernel's CUDA-event ms
           around one call, which adds the host's launch time):
           K1 over all edges (the composed forward) and over the windowed
           residual, with the rows it visits (warp items, long-row
           blocks); K2's forward side, with its block and entry counts
  serve    the main path: predict_patients over 4 batches (123 patients, the
           last batch padded), launch counts zeroed just before, read just
           after; ms per batch
  slice    the forward with kernels against the forward with plain versions
           on the card (bf16 and f32 trunks; probabilities and the pathway
           image), and a small fold on the card against the same fold on
           the CPU
  profile  device time by kernel over full-batch eval steps, windowed and
           composed (profile_composed), with K1's and K2's ms per batch;
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
  profile_train  device time by kernel per train step (K1's and K2's ms
           among them), and the share of the step with no kernel running;
           then the same on the composed path (profile_train_composed: K1
           5 launches a step, K2 0)
  k3       K3 (segment max) at the max-aggregation convs' shapes, F = B*C =
           2048 and B*32 = 1024, bf16 and f32, against its plain version
           (max abs error must be 0), with its ms, plain ms, bound and the
           scatter_reduce amax library call; k1_bwd also times K1 as the
           backward of the two edge gathers (src_gather, dst_gather)

Then, for each of gnn_name mr (MRConv), edge (EdgeConv), gat (GATConv, the
Config's default, f32 with gbm.yaml's final_head 4), gcn (GCNConv) and gin
(GINConv) on the same fold, with a model of the same widths (launches as
conv_launches says: mr / edge K3 2 a batch, K3 2 / K1 5 a step; gat K1 4 a
batch, K1 13 a step; gcn / gin as sage, K2 2 / K1 2 a batch, K2 4 / K1 7
a step):

  serve_<conv>  predict_patients over the 123 patients, launch counts
           zeroed just before and read just after
  profile_<conv>  device time by kernel per eval step of one full batch,
           and the share of the CUDA-event-timed eval step with no kernel
  slice_<conv>  the forward with kernels against plain versions (bf16 and
           f32 trunks; probabilities and the pathway image)
  train_grad_<conv>  one train step's gradients, kernels against plain
           versions, per parameter max|diff| / max|grad|
  train_<conv>  run_fold for 2 epochs (gbm.yaml's optimizer and dropouts),
           launches counted over it; ms per step
  profile_train_<conv>  as profile_train, on one batch: launches per step
           from the counters

and then, on the same fold:

  export_gat  the export phase for a GAT fold (K1 4 a call, K2 0)
  k1_zoo / k2_zoo  the K1 and K2 forms of gat, gcn and gin at gbm.yaml's
           widths against their plain versions, with ms, bound, plain and
           library ms: GAT's edge_segment_sum of its messages (F = B*64 and
           B*32, f32) and softmax terms (F = B*8 and B*4), its gather
           backwards (src_gather / dst_gather, F = B*8; src_gather B*64);
           GCN's K2 forward (F = B*64, B*32) and transpose and its K1
           residual with the weights dinv[s] * dinv[r], bf16; GIN's K2
  options_<option>  each model option on the sage path alone (resgnn,
           dense_gnn, repeat_mask, pca_prelinear, used_omics 01,
           multilevel_gnn_seq, gnn_mlp_norm layer, prelu): one eval forward
           with kernels against plain versions, its launches (sage's), one
           step's gradients against plain versions and one train_step,
           counted; pca_svd and pca_lowrank in f32, eval only, with the ms
           of one forward

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

After the sage training phases, on the same fold:

  repairs  the cost of the bf16 Linear's bias added after the product (as
           flax rounds) against the bias inside it, forward and backward at
           the sage step's two conv MLP shapes (device ms a step); the sage
           step's kernel ms with the repairs (profile_train); the bf16
           forward of a small fold on the card against the CPU (TOL_BF16)
  explain  integrated_gradients (16 steps, B = 32, bf16, windowed): K1 / K2
           launches per call (counts zeroed just before, read just after),
           device ms per call, peak memory, kernels against plain versions
           (TOL_IG), and the survival screen's row count on seeded times
  optim    five radam and five adamw steps on a small fold, card against
           CPU (f32, dropout off), parameters within TOL_OPTIM

And after the protocol phases, on the same files:

  ckpt     run_experiment (gbm.yaml, bf16, 1 run x 5 folds x 4 epochs,
           ckpt_every 1) uninterrupted, then interrupted in fold 1 by the
           interrupt_after hook and resumed: pooled AUC / ACC and every
           fold's test scores must be equal; a step's bytes, load and save
           ms
  predict  the predict CLI on fold 2's checkpoint equals predict_fold with
           the same parameters in memory; ms and launches per batch of 32
  explain_cli  the explain CLI once on fold 0's checkpoint

Then DeeperGCN on the same files (gbm.yaml with model=deepergcn,
hidden_channels=128, num_layers=3: gcn_aggr max, norm layer, block res+,
maxpool readout, bf16 trunk, B = 32, so F = B*H = 4,096 at K3 and K1):

  deepergcn_fold  fold 0's gene-level graph through fold_setup: nodes,
           edges, pathway_edge_num, in-degrees, seconds by stage
  k3_gene  K3 on that fold's receivers at F 4,096 and 8,192 (kirc / lgg's
           B = 64), bf16 and f32, equal to its plain version, with ms,
           bound and scatter_reduce_(amax)'s ms
  k1_gene  K1 as edge_segment_sum's forward (unit weights over dst_gather)
           and as gather_src's backward (over src_gather) at F 4,096, bf16
           and f32, and as the edge-id lookup's backward (the (E, 128) f32
           cotangent into the table's rows, every gene edge into row 0),
           against the plain versions (2e-3 / 1e-4 times max(1, max|ref|)),
           with ms, bound and torch.sparse.mm's ms (index_add_'s for the
           lookup)
  slice_deepergcn  the eval forward with kernels against plain versions,
           gcn_aggr max (equal) and softmax, bf16 and f32 trunks
  serve_deepergcn / profile_deepergcn  predict_patients over 123 patients,
           counted (K3 3 / K1 0 / K2 0 a batch); device ms by kernel and
           the gap share of one full batch
  train_grad_deepergcn  one step's gradients, kernels against plain
           versions, bf16 and f32 (TOL_GRAD's limits)
  profile_train_deepergcn  launches per step from the counters: K3 3 (one
           a layer), K1 4 (each layer's gather_src backward and the edge-id
           lookup's backward); kernel ms and gap share; peak memory
  experiment_deepergcn  the train CLI's main, 1 run x 5 folds x 3 epochs,
           bf16, counted, peak memory; then a small protocol (f32, dropout
           off, 2 epochs) card against CPU, gcn_aggr softmax and max,
           fold test scores within 1e-4

Then the custom ops, export, the profiler trace, the PPI / merge graph
sources and warm, each failing the run when its check fails:

  ops      torch.library.opcheck (schema, fake function, dispatch, aot
           dispatch) of every mgtpu custom op on CUDA tensors over the GBM
           fold's plans (F = 64), right after profile_serve
  export   the GBM sage fold's eval forward (bf16, windowed, B = 32)
           exported with torch.export, saved, and loaded in a fresh
           process: probabilities against the live eval_step on the same
           batch within 1e-6 x max(1, max|ref|), K1 2 / K2 2 launches per
           call as in the live call; the artifact's bytes, load and
           first-call seconds, CUDA-event and device ms of an exported call
           against a live one, the mgtpu ops in the graph and whether
           functionalization added copies (auto_functionalized nodes)
  profile_cli  (after experiment) the train CLI with --profile-dir on the
           protocol files, 1 run x 5 folds x 2 epochs: the trace's bytes,
           K1's kernel symbol in it; wall time against the same protocol
           without it, before and after
  ppi / merge  (after explain_cli) STRING-layout PPI tables (45,000 pair
           rows over the cohort's genes) beside the files: the train CLI at
           gbm.yaml widths with edge_type ppi, then merge, 1 run x 5 folds x
           3 epochs, counted; edges per fold and their path, derivation s;
           profile_train_<edge_type> on fold 0 (launches per step as the
           plans predict, merge running the stack over both graphs); a
           small protocol (f32, dropout off, 2 epochs) card against CPU
           within 1e-4
  gat_protocol_vs_cpu  (after merge) the train CLI on small
           reference-format files with gnn_name gat (f32, dropout off, 1 run
           x 5 folds x 2 epochs) on the card and on the CPU: fold test scores
           within 1e-4, pooled AUC / ACC equal
  warm     the warm CLI in a copy of the package with nothing built (its
           builds' seconds), then the train CLI from that copy: every
           kernel and data library found built (0.0 s)

Kernel cases off the main path (other feature widths, permuted plans,
empty plans) are in tests/test_torch_cuda_kernels.py.

Then the card's nvidia-smi line, the kernels line (per kernel: its serving
numbers, its launches on each path and per train step, its backward forms'
and other forms' numbers) and the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
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
# device-side symbols of each hand-written kernel, to read its rows in a
# profile (K2's launch is its entry pre-pass and its tile kernel)
SYMBOLS = {
    "segment_spmm_csr": ("segment_spmm_csr_kernel",),
    "windowed_tile_spmm": ("win_kernel", "entry_values"),
    "segment_max_csr": ("segment_max_csr_kernel",),
    "sorted_segment_sum": ("sorted_segment_sum_kernel",),
}

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
# gat, gcn, gin.  Readings on an H100 in the f32 trunk: GCN 9.2e-4
# (learnable_pca_params; Conv_1's gradients agree within 2e-7 and Conv_0's
# do not, so the first head conv's relu / max-pool choices moved under a
# 1e-7 change of the image); GAT 8.9e-7 to 5.6e-4 from run to run (its
# attention parameters: the softmax shifted by the column max, as JAX
# shifts it, leaves some segments' denominators tiny, and the plain
# version adds with index_add_'s atomics, in a varying order); limits
# about twice the largest
TOL_GRAD_ZOO = {"bf16": 7e-2, "f32": 2e-3}
CONV_EPOCHS = 2
GBM_FINAL_HEAD = 4  # gbm.yaml's final_head: GAT's last layer's heads


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


WINDOWS = {"kept": 0, "dropped": 0}  # device_ms's profiled windows, over the run


def device_ms(fn, iters: int = 10, windows: int = 3, warmup: int = 3) -> float:
    """Device time of one fn() call in ms: the time of the kernels it
    launches, from the profiler's device rows, per call over iters calls;
    the median of `windows` profiled windows, since a window's record can
    come back short.  Unlike events around a call, it leaves out the
    host's launch time, which sets the events' reading where the kernels
    are short.  Only windows with the most kernel records count, and
    windows are profiled until `windows` such ones are in, up to
    3 * windows (on an H100 all three windows of K1's csc form came back
    empty once, and several forms read below their byte bound, which the
    card cannot do: records were lost)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen = []  # (kernel ms per call, kernel launches per call) of each window
    complete = []
    for _ in range(3 * windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = kernel_rows(prof, iters)
        seen.append((sum(r[1] for r in rows), sum(r[2] for r in rows)))
        # a window whose record came back short has fewer kernel records
        # than the fullest one; only the fullest windows are kept
        full = max(calls for _, calls in seen)
        complete = [ms for ms, calls in seen if calls == full and ms > 0]
        if len(complete) == windows:
            break
    if not complete:
        raise AssertionError("the profiler recorded no kernel in any window")
    WINDOWS["kept"] += len(complete)
    WINDOWS["dropped"] += len(seen) - len(complete)
    return float(np.median(complete))


def kernel_ms(fn, bound_ms: float):
    """(ms, source) of one kernel call: device_ms(fn), unless the profiler
    lost records, and then CUDA events around a loop of 50 calls, whose
    reading includes any gap between the launches.  Lost records show as
    a reading below the call's bound, which the card cannot do, or below
    half the loop's where the loop reads over 1 ms a call (calls that long
    keep the card busy back to back, so the loop then reads the device
    time).  On an H100, late in a long run of this script several profiled
    forms read below their byte bound (K4a 0.1795 against 0.2254 ms), while
    a fresh process read the same call at 0.2565 ms by the profiler and
    0.2579 by such a loop (probes/timing_check.py); the edge-id lookup's
    backward read 1.08 ms by the profiler and 5.50 by events where a fresh
    process read 5.41 by both."""
    ms = device_ms(fn)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(50):
        fn()
    b.record()
    b.synchronize()
    loop = a.elapsed_time(b) / 50
    if ms >= bound_ms and not (loop > 1.0 and ms < 0.5 * loop):
        return ms, "profiler"
    return loop, "events_loop"


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median time of fn() in ms, CUDA events around each call (the host's
    launch time included where the device waits for it)."""
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
    ms, src = kernel_ms(kern, bms)
    return dict(
        case=name, dtype=str(dt).split(".")[-1], nnz=plan.nnz, F=x.shape[1],
        warp_rows=plan.n_busy if acc else int(plan.items.shape[0]),
        long_rows=int(plan.long_rows.shape[0]),
        max_abs_err=e, ref_max=m, limit=limit, ms=ms, ms_source=src,
        event_ms=cuda_ms(kern), plain_ms=device_ms(plain),
        library_ms=device_ms(library) if library is not None else None,
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
    # the kernel adds each entry's row with f32 FMAs on the CUDA cores
    bms, by = bound(b, fl, "f32")
    vals = torch.zeros(side.n_entries, device="cuda").index_add_(
        0, side.edge_ent.long(), w.index_select(0, side.edge_eid.long())
    )
    lib = library_spmm(side.ent_dst_orig.long(), side.ent_src_orig.long(),
                       vals, plan.num_nodes, plan.num_nodes, x)
    ms, src = kernel_ms(kern, bms)
    return dict(
        case=name, dtype=str(dt).split(".")[-1], F=x.shape[1],
        blocks=side.n_blocks, entries=side.n_entries, max_abs_err=e,
        ref_max=m, limit=limit, ms=ms, ms_source=src, event_ms=cuda_ms(kern),
        plain_ms=device_ms(plain), library_ms=device_ms(lib) if lib is not None else None,
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
        lib_ms = device_ms(library)
    except (RuntimeError, NotImplementedError):
        lib_ms = None
    del rows, idx, dst
    ms, src = kernel_ms(lambda: k3.segment_max_csr(msg, plan), bms)
    return dict(
        case=f"csr F={F}", dtype=str(dt).split(".")[-1], nnz=plan.nnz, F=F,
        max_abs_err=e, ref_max=m, limit=0.0, ms=ms, ms_source=src,
        event_ms=cuda_ms(lambda: k3.segment_max_csr(msg, plan)),
        plain_ms=device_ms(lambda: k3.segment_max_csr_plain(msg, plan)),
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


def kernel_zoo(graph, B, C, final, heads, gen):
    """The K1 / K2 forms that gat, gcn and gin give the GBM fold at gbm.yaml's
    widths (B, hidden C, final channels, final_head heads), each against its
    plain version: GAT's edge_segment_sum of f32 messages (K1 over
    dst_gather, unit weights) at F = B*C and B*final, and of its softmax
    terms at F = B*8 and B*heads; the backward of its gathers, K1 over
    src_gather / dst_gather at F = B*8 (a_src, a_dst, the denominators) and
    over src_gather at F = B*C (the messages); GCN's K2 forward and
    transpose and its K1 residual with the weights dinv[s] * dinv[r], bf16,
    F = B*C and B*final; GIN's K2 forward with unit weights, F = B*C.
    Libraries: torch.sparse.mm, and index_add_ for a gather's backward."""
    plan = graph.winplan
    E = graph.num_padded_edges
    ones = torch.ones(E, device="cuda")
    coef = spmm.edge_weights(graph, "sum", graph.gcn_coef)
    out = {}
    for case, F in (("gat_messages", B * C), ("gat_messages", B * final),
                    ("gat_softmax", B * 8), ("gat_softmax", B * heads)):
        x = torch.randn(E, F, generator=gen, device="cuda")
        out[(case, F)] = time_k1(f"{case} F={F}", graph.dst_gather, x, ones, False, gen)
        emit({"phase": "k1_zoo", **out[(case, F)]})
        del x
    for case, p, ids, F in (("gat_src_gather_bwd", graph.src_gather, graph.senders, B * 8),
                            ("gat_dst_gather_bwd", graph.dst_gather, graph.receivers, B * 8),
                            ("gat_src_gather_bwd", graph.src_gather, graph.senders, B * C)):
        g = torch.randn(E, F, generator=gen, device="cuda")
        dst = torch.zeros(graph.n_nodes, F, device="cuda")
        out[(case, F)] = time_k1(f"{case} F={F}", p, g, ones, False, gen,
                                 library=lambda ids=ids, g=g, dst=dst:
                                 dst.zero_().index_add_(0, ids, g))
        emit({"phase": "k1_zoo", **out[(case, F)]})
        del g, dst
    for F in (B * C, B * final):
        x = torch.randn(graph.n_nodes, F, generator=gen, device="cuda").to(torch.bfloat16)
        out[("gcn_residual", F)] = time_k1(f"gcn_residual F={F}", plan.res, x, coef, True, gen)
        emit({"phase": "k1_zoo", **out[("gcn_residual", F)]})
        out[("gcn_k2", F)] = time_k2(f"gcn forward F={F}", plan, x, coef, False)
        emit({"phase": "k2_zoo", **out[("gcn_k2", F)]})
        del x
    x = torch.randn(graph.n_nodes, B * C, generator=gen, device="cuda").to(torch.bfloat16)
    out[("gcn_k2_t", B * C)] = time_k2(f"gcn transpose F={B * C}", plan, x, coef, True)
    emit({"phase": "k2_zoo", **out[("gcn_k2_t", B * C)]})
    out[("gin_k2", B * C)] = time_k2(f"gin forward F={B * C}", plan, x, ones, False)
    emit({"phase": "k2_zoo", **out[("gin_k2", B * C)]})
    return out


def launch_counts():
    return {k.name: k.launches for k in build.REGISTRY.values()}


def zero_launches():
    for k in build.REGISTRY.values():
        k.launches = 0


def port_kernel_ms(rows):
    """Device ms of each hand-written kernel among profiler rows."""
    return {k: sum(t for n, t, _ in rows if any(sym in n for sym in syms))
            for k, syms in SYMBOLS.items()}


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


def profile_serve(model, ctx, batch):
    """profile_eval on one full batch, then the windowed path against the
    composed one (K1 over all edges) end to end, in turns, with each
    path's kernel launches counted; serve_paths' gap share is the part of
    the windowed eval_step (CUDA events) with no kernel running."""
    composed = composed_ctx(ctx)
    busy = profile_eval(model, ctx, batch, "profile")
    profile_eval(model, composed, batch, "profile_composed")

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


def composed_ctx(ctx):
    """The fold's context without its window plan: K1 over all edges."""
    return dataclasses.replace(
        ctx, graph=dataclasses.replace(ctx.graph, winplan=None))


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
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return float(loss.detach()), grads, {n for n, _ in model.named_parameters()} - set(grads)


def train_grad_checks(models, ctx, batch, cw, phase="train_grad", tol=TOL_GRAD,
                      no_grad=frozenset()):
    """One step's gradients with kernels against the same step with plain
    versions (forward and backward), same params, same dropout masks.
    models: (trunk name, model) pairs.  no_grad: the parameters the loss
    does not reach; on both sides exactly these have no gradient."""
    for name, m in models:
        lk, gk, nk = grads_of(m, batch, ctx, cw, seed=5)
        with spmm.plain_versions():
            lp, gp, np_ = grads_of(m, batch, ctx, cw, seed=5)
        torch.cuda.synchronize()
        rel = {}
        for n in gk.keys() & gp.keys():
            gmax = float(gp[n].abs().max())
            rel[n] = float((gk[n] - gp[n]).abs().max()) / max(gmax, 1e-30)
        worst = max(rel.values())
        finite = all(bool(torch.isfinite(g).all()) for g in gk.values())
        same_keys = nk == np_ == set(no_grad)
        ok = finite and same_keys and worst <= tol[name]
        emit({"phase": phase, "trunk": name, "loss": lk,
              "loss_plain": lp, "max_rel_err": worst, "tol": tol[name],
              "rel_err_by_param": rel, "no_grad": sorted(nk), "no_grad_plain": sorted(np_),
              "no_grad_expected": sorted(no_grad), "finite": finite, "ok": ok})
        if not ok:
            raise AssertionError(f"{phase} {name}: kernels vs plain {worst}, "
                                 f"without a gradient {sorted(nk)} / {sorted(np_)}")
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
    per_batch, per_step = conv_launches("sage", plan)
    want = {k: per_step[k] * n_steps + per_batch[k] * n_eval for k in per_step}
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
          "launches_expected": want, "launches_per_step_expected": per_step,
          "losses": res.step_losses, "max_param_move": moved,
          "valid_auc": valid_auc, "valid_loss": [v[2] for v in res.epoch_valid],
          "test_auc_at_check": {
              e: float(M.roc_auc(res.y_true, s))
              for e, s in res.epoch_pred_by_epoch.items()},
          "replay_max_abs_loss_diff": replay, "replay_tol": TOL_REPLAY,
          "ok": ok})
    if not ok:
        raise AssertionError("train phase failed")
    return dict(per_step=per_step,
                batch=next(iter_batches(X, Y, ages, tr, cfg.batch_size, "cuda")),
                model=model, cw=torch.as_tensor(cw, dtype=torch.float32, device="cuda"))


def timed_steps(step, n):
    """(CUDA-event ms of each of n calls of step(), launches per call)."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    zero_launches()
    events = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events], {k: v / n for k, v in launch_counts().items()}


def profiled(step, n=3):
    """(device ms of kernels per call, kernels per call, kernel_rows) of n
    calls of step() under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    rows = kernel_rows(prof, n)
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows


def top_rows(rows, n):
    return [{"name": nm, "ms": t, "calls": c} for nm, t, c in rows[:n]]


def profile_train(model, ctx, batch, cw, want_per_step, n_timed=10, n_prof=3,
                  phase="profile_train"):
    """One batch and one optimizer: n_timed train steps timed with CUDA
    events and their kernel launches counted (per step), then n_prof steps
    under the profiler for device time by kernel.  The gap share is the
    part of the median timed step with no kernel running."""
    opt = make_optimizer(model, model.cfg, 6)
    gen = torch.Generator(device="cuda").manual_seed(9)

    def step():
        train_step(model, opt, batch, ctx, cw, gen)

    ms, per_step = timed_steps(step, n_timed)
    busy, n_kernels, rows = profiled(step, n_prof)
    step_ms = float(np.median(ms))
    ok = per_step == want_per_step
    emit({"phase": phase, "kernel_ms_per_step": busy,
          "kernels_per_step": n_kernels,
          "step_ms": ms, "step_ms_median": step_ms,
          "gap_share": 1 - busy / step_ms,
          "port_kernel_ms_per_step": port_kernel_ms(rows),
          "launches_per_step": per_step, "launches_per_step_expected": want_per_step,
          "top": top_rows(rows, 16), "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: launches per step {per_step}, want {want_per_step}")
    return per_step, busy


def profile_eval(model, ctx, batch, phase, n_timed=10, n_prof=3):
    """Device time by kernel over n_prof eval steps of one full batch, and
    the share of the median CUDA-event-timed eval step (n_timed of them)
    with no kernel running."""
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
    busy, n_kernels, rows = profiled(lambda: eval_step(model, batch, ctx), n_prof)
    emit({"phase": phase, "kernel_ms_per_batch": busy,
          "kernels_per_batch": n_kernels,
          "port_kernel_ms_per_batch": port_kernel_ms(rows),
          "eval_step_ms_median": step_ms, "gap_share": 1 - busy / step_ms,
          "top": top_rows(rows, 14)})
    return busy


def conv_launches(conv, plan):
    """(per serving batch, per train step) launches of each kernel with
    gnn_name conv on a fold whose window plan is plan.  mr / edge: K3 a
    layer, K1 as the two edge gathers' backwards a layer and the PCA
    gather's.  gat: K1 twice a layer (the softmax denominators and the
    messages, edge_segment_sum), and as the backward of its four gathers a
    layer (a_src, a_dst, the denominators, the messages) and the PCA
    gather's.  sage / gcn / gin: K2 a layer with the K1 residual, and in
    the backward K2's transpose with K1 over tres and res_csc, and the PCA
    gather's K1."""
    zero = {k1.KERNEL.name: 0, k2.KERNEL.name: 0, k3.KERNEL.name: 0, k4.name: 0}
    if conv in ("mr", "edge"):
        return {**zero, k3.KERNEL.name: 2}, {**zero, k3.KERNEL.name: 2, k1.KERNEL.name: 5}
    if conv == "gat":
        return {**zero, k1.KERNEL.name: 4}, {**zero, k1.KERNEL.name: 13}
    res, tres = int(plan.n_res > 0), int(plan.n_tres > 0)
    return ({**zero, k1.KERNEL.name: 2 * res, k2.KERNEL.name: 2},
            {**zero, k1.KERNEL.name: 2 * res + 2 * (tres + res) + 1, k2.KERNEL.name: 4})


def serve_conv(conv, model, ctx, n_batches):
    """One conv's serving path: predict_patients over N_PATIENTS, counted,
    launches as conv_launches says a batch."""
    X, Y, ages = patients(ctx.graph.n_nodes)
    res, launches, dt, ok = serve_counted(model, ctx, X, Y, ages)
    per_batch = conv_launches(conv, ctx.graph.winplan)[0]
    want = {k: v * n_batches for k, v in per_batch.items()}
    ok = bool(ok and launches == want)
    emit({"phase": f"serve_{conv}", "batches": n_batches, "patients": N_PATIENTS,
          "ms_per_batch": dt * 1e3 / n_batches, "launches": launches,
          "launches_expected": want, "auc": res["auc"], "acc": res["acc"],
          "loss": res["loss"], "ok": ok})
    if not ok:
        raise AssertionError(f"serve_{conv} phase failed")
    return launches


def train_conv(conv, cfg, ctx):
    """run_fold with one conv for CONV_EPOCHS epochs, counted; then
    profile_train on one batch, which reads the launches per step from
    the counters (conv_launches)."""
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
    per_batch, per_step = conv_launches(conv, ctx.graph.winplan)
    want = {k: per_step[k] * n_steps + per_batch[k] * n_eval for k in per_step}
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
    return profile_train(model, ctx, batch, cwt, per_step,
                         phase=f"profile_train_{conv}")[0]


def conv_paths(conv, cfg, ctx, batch, n_batches):
    """Every phase of one conv on the GBM fold; cfg is the training config
    (gbm.yaml's optimizer and dropouts, bf16 trunk).  mr / edge differ from
    their plain versions only in K3, which is exact; gat runs in f32, so
    its bf16 trunk is held like the f32 one; gcn / gin run the bf16 SpMMs
    as sage does."""
    ccfg = cfg.replace(gnn_name=conv, final_head=GBM_FINAL_HEAD)
    n, G = ctx.graph.n_nodes, ctx.num_pca_rows

    def make(c):
        return lambda: MultilevelGNN(c, n, G, device="cuda", seed=0)

    f32 = ccfg.replace(compute_dtype=None, spmm_bf16=False)
    tol_img = TOL_IMAGE_BF16 if conv in ("gcn", "gin") else TOL_IMAGE_F32
    tol_grad = TOL_GRAD_MAX if conv in ("mr", "edge") else TOL_GRAD_ZOO
    model = make(ccfg)()
    serve = serve_conv(conv, model, ctx, n_batches)
    profile_eval(model, ctx, batch, f"profile_{conv}")
    forward_vs_plain(f"slice_{conv}", (("bf16", tol_img, lambda: model),
                                       ("f32", TOL_IMAGE_F32, make(f32))), ctx, batch)
    cw = torch.tensor([1.0, 1.5], device="cuda")
    train_grad_checks((("bf16", model),), ctx, batch, cw,
                      phase=f"train_grad_{conv}", tol=tol_grad)
    del model
    m32 = make(f32)()
    train_grad_checks((("f32", m32),), ctx, batch, cw,
                      phase=f"train_grad_{conv}", tol=tol_grad)
    del m32
    per_step = train_conv(conv, ccfg.replace(epochs=CONV_EPOCHS), ctx)
    torch.cuda.empty_cache()
    return serve, per_step


# The model options of the sage path, each on its own at gbm.yaml's widths:
# resgnn with final_channels = hidden (64), so x + layer(x) adds; repeat_mask
# with repeat_cyclic 1, so the mask repeats after layer 0 of two; the
# runtime PCA reductions in f32 (the JAX package refuses a bf16 SVD or QR)
# and eval only.  An SVD's singular vectors follow its input's tiny changes
# in sign, and by rotation where singular values lie close: with the
# kernels' f32 sums in another order than the plain versions', an H100 read
# 4 sign flips of 28,032 (channel, slot, column)s and 2.5e-3 of max|image|
# after aligning the signs.  So the kernels are held where they act, on the
# rows the reduction takes, and the image's differences are reported
OPTIONS = {
    "resgnn": dict(resgnn=True, final_channels=64),
    "dense_gnn": dict(dense_gnn=True),
    "repeat_mask": dict(repeat_mask=True, repeat_norm=True, repeat_cyclic=1),
    "pca_prelinear": dict(pca_prelinear=True),
    "used_omics_01": dict(used_omics="01"),
    "multilevel_gnn_seq": dict(model="multilevel_gnn_seq", only_mrna_pred=True),
    "gnn_mlp_norm_layer": dict(gnn_mlp_norm="layer"),
    "prelu": dict(gnn_act="prelu"),
    "pca_svd": dict(reduction_method="pca_svd", compute_dtype=None, spmm_bf16=False),
    "pca_lowrank": dict(reduction_method="pca_lowrank", compute_dtype=None, spmm_bf16=False),
}
TOL_PCA_ROWS = 1e-6  # times max|rows|: the reduction's input, kernels against plain


def pca_vs_plain(phase, m, ctx, batch):
    """A runtime-PCA forward with kernels against plain versions: the rows
    the reduction takes within TOL_PCA_ROWS; the image's sign flips, its
    difference after the signs are aligned and the probabilities'
    difference are reported (they follow the solver)."""
    rows = []
    reduce = m.runtime_pca_image
    m.runtime_pca_image = lambda xg: (rows.append(xg), reduce(xg))[1]
    m.eval()
    try:
        with torch.no_grad():
            pk, ik = m(batch, ctx)
            with spmm.plain_versions():
                pp, ip = m(batch, ctx)
    finally:
        del m.runtime_pca_image
    torch.cuda.synchronize()
    err, rmax = err_of(rows[0], rows[1])
    B, C = ik.shape[:2]
    a = ik.reshape(B, C, -1, m.cfg.pca_dim)
    b = ip.reshape(B, C, -1, m.cfg.pca_dim)
    sign = torch.sign((a * b).sum(0))
    sign[sign == 0] = 1
    img_err, im = err_of(a * sign, b)
    finite = bool(torch.isfinite(pk).all() and torch.isfinite(ik).all())
    ok = finite and rmax > 0 and err <= TOL_PCA_ROWS * rmax
    emit({"phase": phase, "trunk": "f32", "max_abs_err_rows": err, "rows_max": rmax,
          "tol_rows": TOL_PCA_ROWS, "sign_flips": int((sign < 0).sum()),
          "columns": int(sign.numel()), "max_abs_err_image_aligned": img_err,
          "image_max": im, "max_abs_err_prob": float((pk - pp).abs().max()),
          "finite": finite, "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: kernels vs plain on the reduction's rows")


def options_phase(cfg, ctx, batch):
    """Each option of OPTIONS on the sage path of the GBM fold: one eval
    forward with kernels against plain versions (forward_vs_plain's
    limits), launches counted over one eval_step (K2 2 and the K1 residual
    2, as sage); then, but for the PCA reductions, one step's gradients
    against plain versions (TOL_GRAD) and one train_step, counted (sage's
    launches a step).  The PCA reductions' forward ms (a Python loop over
    the 438 slots' SVDs or QRs in both packages)."""
    slots = tuple(int(c) for c in np.bincount(ctx.raw_indice.cpu().numpy(),
                                              minlength=3 * cfg.pathway_num))
    n, G = ctx.graph.n_nodes, ctx.num_pca_rows
    per_batch, per_step = conv_launches("sage", ctx.graph.winplan)
    cw = torch.tensor([1.0, 1.5], device="cuda")
    res = {}
    for name, kw in OPTIONS.items():
        c = cfg.replace(slot_sizes=slots, **kw)
        trunk = "bf16" if c.compute_dtype else "f32"
        m = MultilevelGNN(c, n, G, device="cuda", seed=0)
        pca = c.reduction_method != "linear_projection"
        if pca:
            pca_vs_plain(f"options_{name}", m, ctx, batch)
        else:
            tol_img = TOL_IMAGE_BF16 if trunk == "bf16" else TOL_IMAGE_F32
            forward_vs_plain(f"options_{name}", ((trunk, tol_img, lambda: m),), ctx, batch)
        m.eval()
        torch.cuda.synchronize()
        zero_launches()
        probs = eval_step(m, batch, ctx)[0]
        torch.cuda.synchronize()
        eval_launches = launch_counts()
        row = {"phase": f"options_{name}_counts", "trunk": trunk, "eval_launches": eval_launches,
               "finite": bool(torch.isfinite(probs).all())}
        ok = row["finite"] and eval_launches == per_batch
        if pca:
            with torch.no_grad():
                # one call (pca_vs_plain warmed it): pca_svd's 438 slots of
                # batched SVDs take seconds on an H100
                row["forward_ms"] = cuda_ms(lambda: m(batch, ctx), iters=1, warmup=0)
        else:
            train_grad_checks(((trunk, m),), ctx, batch, cw, phase=f"options_grad_{name}")
            opt = make_optimizer(m, c, 6)
            gen = torch.Generator(device="cuda").manual_seed(3)
            torch.cuda.synchronize()
            zero_launches()
            loss = train_step(m, opt, batch, ctx, cw, gen)
            torch.cuda.synchronize()
            row["step_launches"], row["loss"] = launch_counts(), float(loss)
            ok = ok and row["step_launches"] == per_step and bool(np.isfinite(row["loss"]))
        row["ok"] = ok
        emit(row)
        if not ok:
            raise AssertionError(f"options_{name} failed")
        res[name] = row
        del m
        torch.cuda.empty_cache()
    return res


def gat_protocol_phase(small_root):
    """The train CLI on the small reference-format files with gnn_name gat
    (f32, dropout off, 1 run x 5 folds x 2 epochs), on the card and on the
    CPU: each fold's test scores within TOL_PROTOCOL, pooled AUC and ACC
    equal; the card's run counted (K1 only: the small folds are composed)."""
    from multilevel_gnn_tpu_torch.train import cli

    sets = ["gnn_name=gat", "final_head=4", "num_run=1", "epochs=2",
            "compute_dtype=null", "spmm_bf16=false", "feature_drop=false",
            "head_drop_rate=0.0", "gnn_dropout=0.0"]
    out = {}
    for dev in ("cuda", "cpu"):
        sync("cuda")
        zero_launches()
        rec, undo = _spy_folds()
        try:
            res = cli.main(["--config", GBM_YAML, "--data-dir", small_root, "--device", dev,
                            "--set", *sets])
        finally:
            undo()
        sync("cuda")
        out[dev] = (rec, res, launch_counts())
    (rc, resc, launches), (rp, resp, _) = out["cuda"], out["cpu"]
    errs = [max(float(np.abs(a.epoch_pred[2] - b.epoch_pred[2]).max()),
                float(np.abs(a.epoch_pred_by_epoch[2] - b.epoch_pred_by_epoch[2]).max()))
            for a, b in zip(rc, rp)]
    ok = bool(len(errs) == 5 and max(errs) <= TOL_PROTOCOL
              and resc["auc"][2] == resp["auc"][2] and resc["acc"][2] == resp["acc"][2]
              and launches[k1.KERNEL.name] > 0 and launches[k2.KERNEL.name] == 0
              and launches[k3.KERNEL.name] == 0)
    emit({"phase": "gat_protocol_vs_cpu", "fold_max_abs_err": errs, "tol": TOL_PROTOCOL,
          "pooled_auc": [resc["auc"][2], resp["auc"][2]],
          "pooled_acc": [resc["acc"][2], resp["acc"][2]], "launches_cuda": launches,
          "wall_s": [resc["wall_time_s"], resp["wall_time_s"]], "ok": ok})
    if not ok:
        raise AssertionError("gat protocol: card vs CPU mismatch")
    return launches


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
        lib_ms = device_ms(library)
    except (RuntimeError, NotImplementedError, TypeError):
        lib_err, lib_ms = None, None
    ms, src = kernel_ms(kern, bms)
    return dict(
        case=case, dtype=str(dt).split(".")[-1], shape=list(data.shape),
        n_kept=plan.n_kept, segments=plan.num_segments, max_abs_err=e, ref_max=m,
        limit=limit, ms=ms, ms_source=src, event_ms=cuda_ms(kern), plain_ms=device_ms(plain),
        library_ms=lib_ms,
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
    return cohort


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


# ---- the bf16 repairs, checkpoints, predict, explain, optimizers
# integrated gradients with kernels against plain versions, max|diff| /
# max|ref| over the (B, NODES) attributions: the limits of TOL_GRAD, since
# IG sums input gradients of the same forward and backward
TOL_IG = {"bf16": 7e-2, "f32": 6e-6}
TOL_OPTIM = 1e-5  # five radam / adamw steps, card against CPU (f32, small)
IG_STEPS = 16
CKPT_EPOCHS = 4


def repairs_phase(model, ctx, train_kernel_ms):
    """F1's cost at the sage step's biased bf16 Linear shapes (the two
    conv MLPs): forward and backward with the bias inside the product
    (one rounding) and added after it (flax's rounding, the port's form),
    device ms from the profiler; the train step's kernel ms with the
    repairs (profile_train); and the bf16 forward of a small fold on the
    card against the same fold on the CPU."""
    import torch.nn.functional as F

    rows = ctx.graph.n_nodes * model.cfg.batch_size
    gen = torch.Generator(device="cuda").manual_seed(11)
    ms = {"bias_in_product": 0.0, "bias_after_product": 0.0}
    shapes = []
    for i in range(model.n_layers):
        lin = getattr(model, f"gnn_{i}").gconv.nn.Linear_0
        cout, cin = lin.weight.shape
        shapes.append([rows, cin, cout])
        x = torch.randn(rows, cin, generator=gen, device="cuda").bfloat16().requires_grad_()
        w = torch.randn(cout, cin, generator=gen, device="cuda").bfloat16().requires_grad_()
        b = torch.randn(cout, generator=gen, device="cuda").bfloat16().requires_grad_()
        g = torch.randn(rows, cout, generator=gen, device="cuda").bfloat16()
        for form in ms:
            def run(form=form):
                y = F.linear(x, w, b) if form == "bias_in_product" else F.linear(x, w) + b
                y.backward(g)
                x.grad = w.grad = b.grad = None
            ms[form] += device_ms(run)
        del x, w, b, g
    res = {}
    for dev in ("cuda", "cpu"):
        _, m, _, c, bt = make_gbm_scale_setup(
            node_num=300, n_pathways=12, batch=8, gene_rows=900, topology="cohort",
            windowed=True, device=dev, compute_dtype="bfloat16", spmm_bf16=True)
        with torch.no_grad():
            m.eval()
            res[dev] = [t.float().cpu() for t in m(bt, c)]
    e_prob, m_prob = err_of(res["cuda"][0], res["cpu"][0])
    e_img, m_img = err_of(res["cuda"][1], res["cpu"][1])
    ok = (e_prob <= TOL_BF16 * max(1.0, m_prob) and e_img <= TOL_BF16 * max(1.0, m_img)
          and bool(torch.isfinite(res["cuda"][1]).all()))
    emit({"phase": "repairs", "train_kernel_ms_per_step": train_kernel_ms,
          "linear_shapes": shapes, "linear_fwd_bwd_ms_per_step": ms,
          "bias_add_cost_ms_per_step": ms["bias_after_product"] - ms["bias_in_product"],
          "bf16_small_card_vs_cpu": {"prob_max_abs_err": e_prob, "image_max_abs_err": e_img,
                                     "image_max": m_img, "tol": TOL_BF16},
          "ok": ok})
    if not ok:
        raise AssertionError("repairs: bf16 card vs CPU mismatch")


def explain_phase(model, ctx, batch):
    """integrated_gradients at the GBM fold (bf16 trunk, windowed, B = 32,
    IG_STEPS steps): launches per call (counts zeroed just before), device
    ms per call from the profiler, peak memory, kernels against plain
    versions (max|diff| / max|ref|), then the pathway attributions and the
    survival screen of the batch on seeded survival times."""
    from torch.profiler import ProfilerActivity, profile

    from multilevel_gnn_tpu_torch.train.explain import integrated_gradients, pathway_attributions
    from multilevel_gnn_tpu_torch.utils.survival import pathway_km_screen

    integrated_gradients(model, batch, ctx, steps=2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_launches()
    t0 = time.perf_counter()
    ig = integrated_gradients(model, batch, ctx, steps=IG_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        integrated_gradients(model, batch, ctx, steps=IG_STEPS)
        torch.cuda.synchronize()
    rows = kernel_rows(prof, 1)
    busy = sum(r[1] for r in rows)
    with spmm.plain_versions():
        ref = integrated_gradients(model, batch, ctx, steps=IG_STEPS)
    torch.cuda.synchronize()
    e, m = err_of(ig, ref)
    trunk = "bf16" if model.cfg.compute_dtype else "f32"
    rng = np.random.RandomState(4)
    n = batch.x.shape[0]
    scores = pathway_attributions(ig, ctx, model.cfg.pathway_num)
    screen = pathway_km_screen(scores, np.round(rng.exponential(20.0, n)),
                               (rng.rand(n) < 0.7).astype(int),
                               [f"p{i}" for i in range(model.cfg.pathway_num)])
    ok = (bool(torch.isfinite(ig).all()) and m > 0 and e <= TOL_IG[trunk] * m
          and launches[k1.KERNEL.name] > 0 and launches[k2.KERNEL.name] > 0
          and launches[k3.KERNEL.name] == 0 and launches[k4.name] == 0 and len(screen) > 0)
    emit({"phase": "explain", "steps": IG_STEPS, "batch": n, "trunk": trunk,
          "launches_per_call": launches,
          "device_ms_per_call": busy, "wall_ms_per_call": wall * 1e3,
          "port_kernel_ms_per_call": port_kernel_ms(rows),
          "peak_mem_mib": peak / 2**20, "max_abs_err_vs_plain": e, "ref_max": m,
          "tol_rel": TOL_IG[trunk], "km_rows": len(screen),
          "top": [{"name": nm, "ms": t, "calls": c} for nm, t, c in rows[:10]], "ok": ok})
    if not ok:
        raise AssertionError("explain phase failed")
    return launches


def optim_phase():
    """Five steps each of radam and adamw on a small fold, on the card and
    on the CPU (f32 trunk, dropout off, clip and weight decay on):
    parameters within TOL_OPTIM."""
    out = {}
    for name in ("radam", "adamw"):
        params, losses = {}, {}
        for dev in ("cuda", "cpu"):
            cfg, _, graph, ctx, batch = make_gbm_scale_setup(
                node_num=300, n_pathways=12, batch=8, gene_rows=900, topology="cohort",
                windowed=True, device=dev)
            cfg = cfg.replace(feature_drop=False, head_drop_rate=0.0, gnn_dropout=0.0,
                              clip_grad=True, wd=1e-3, lr=1e-3)
            m = MultilevelGNN(cfg, graph.n_nodes, ctx.num_pca_rows, device=dev, seed=0)
            opt = make_optimizer(m, cfg, 3, name=name)
            cw = torch.tensor([1.0, 1.5], device=dev)
            losses[dev] = [float(train_step(m, opt, batch, ctx, cw, None)) for _ in range(5)]
            params[dev] = {k: v.detach().float().cpu() for k, v in m.state_dict().items()}
        err = max(float((params["cuda"][k] - params["cpu"][k]).abs().max())
                  for k in params["cpu"])
        moved = max(float((params["cpu"][k] - MultilevelGNN(
            cfg, graph.n_nodes, ctx.num_pca_rows, device="cpu", seed=0
        ).state_dict()[k]).abs().max()) for k in params["cpu"])
        out[name] = {"param_max_abs_err": err, "losses_cuda": losses["cuda"],
                     "losses_cpu": losses["cpu"], "max_param_move": moved}
    ok = all(v["param_max_abs_err"] <= TOL_OPTIM and v["max_param_move"] > 0
             for v in out.values())
    emit({"phase": "optim", "steps": 5, "tol": TOL_OPTIM, **out, "ok": ok})
    if not ok:
        raise AssertionError("optim: card vs CPU mismatch")


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def ckpt_phase(root, cohort, device="cuda"):
    """The protocol on the cohort files (gbm.yaml, bf16, 1 run x 5 folds x
    CKPT_EPOCHS epochs, ckpt_every 1) uninterrupted, then interrupted in
    fold 1 by the interrupt_after hook and resumed: pooled AUC / ACC and
    every fold's test scores must be equal.  Also a step's bytes, and one
    step's load (model, optimizer, generator) and save timed.  Returns the
    uninterrupted run's ckpt dir."""
    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.train import checkpoint as C
    from multilevel_gnn_tpu_torch.train import driver, predict

    cfg = Config.from_yaml(GBM_YAML).replace(num_run=1, epochs=CKPT_EPOCHS, ckpt_every=1)
    a_dir, b_dir = f"{root}/ckpt_a", f"{root}/ckpt_b"
    t0 = time.perf_counter()
    a = driver.run_experiment(cfg, cohort, device=device, ckpt_dir=a_dir)
    t_a = time.perf_counter() - t0
    interrupted_at = None
    try:
        driver.run_experiment(cfg, cohort, device=device, ckpt_dir=b_dir,
                              interrupt_after=[CKPT_EPOCHS + 2])
    except KeyboardInterrupt as e:
        interrupted_at = str(e)
    t0 = time.perf_counter()
    b = driver.run_experiment(cfg, cohort, device=device, ckpt_dir=b_dir, resume=True)
    t_b = time.perf_counter() - t0
    e = CKPT_EPOCHS
    pooled_equal = all(a[k] == b[k] for k in ("auc", "acc", "auc_by_loss", "acc_by_loss",
                                                "auc_by_epoch", "acc_by_epoch"))
    fold_diff = []
    for f in range(5):
        fa = np.load(f"{a_dir}/result_run0_fold{f}.npy", allow_pickle=True).item()
        fb = np.load(f"{b_dir}/result_run0_fold{f}.npy", allow_pickle=True).item()
        fold_diff.append(max(float(np.abs(getattr(fa, k)[e] - getattr(fb, k)[e]).max())
                             for k in ("epoch_pred", "epoch_pred_by_loss",
                                       "epoch_pred_by_epoch")))
    tag = f"{a_dir}/run0_fold0"
    step = C.latest_resumable_step(tag)
    step_bytes = _dir_bytes(f"{tag}/step_{step}") + os.path.getsize(
        f"{tag}/step_{step}.host.npy")
    st = predict.load_fold_state(cfg, cohort, None, 0, 0, device=device)
    opt = make_optimizer(st["model"], st["cfg"], 1)
    gen = torch.Generator(device=device)
    sync(device)
    t0 = time.perf_counter()
    tree, _ = C.load_checkpoint(tag, step)
    st["model"].load_state_dict(tree["model"])
    opt.load_state_dict(tree["optimizer"])
    gen.set_state(tree["generator"])
    sync(device)
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    C.save_checkpoint(f"{root}/ckpt_t", st["model"], opt, gen, step=1)
    save_ms = (time.perf_counter() - t0) * 1e3
    ok = (interrupted_at is not None and pooled_equal and max(fold_diff) == 0.0
          and [f.get("loaded", False) for f in b["folds"]] == [True] + [False] * 4)
    emit({"phase": "ckpt", "epochs": CKPT_EPOCHS, "interrupted": interrupted_at,
          "pooled_auc": a["auc"][e], "pooled_auc_resumed": b["auc"][e],
          "pooled_acc": a["acc"][e], "pooled_acc_resumed": b["acc"][e],
          "pooled_equal": pooled_equal, "fold_test_score_max_abs_diff": fold_diff,
          "uninterrupted_s": t_a, "resumed_s": t_b, "step_bytes": step_bytes,
          "save_ms": save_ms, "load_ms": load_ms,
          "loaded": [f.get("loaded", False) for f in b["folds"]], "ok": ok})
    if not ok:
        raise AssertionError("ckpt: the resumed protocol differs from the uninterrupted one")
    return a_dir


def predict_phase(root, cohort, ckpt_dir, device="cuda"):
    """The predict CLI on fold 2's checkpoint against predict_fold with the
    same parameters loaded in memory (equal), then predict_fold timed with
    its launches counted per batch (B = 32)."""
    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.train import predict
    from multilevel_gnn_tpu_torch.train.checkpoint import load_checkpoint

    cfg = Config.from_yaml(GBM_YAML)
    cli_res = predict.main(["--config", GBM_YAML, "--ckpt-dir", ckpt_dir, "--fold", "2",
                            "--data-dir", root, "--device", device])
    st = predict.load_fold_state(cfg, cohort, None, 0, 2, device=device)
    st["model"].load_state_dict(load_checkpoint(f"{ckpt_dir}/run0_fold2")[0]["model"])
    mem = predict.predict_fold(cfg, cohort, None, 0, 2, model=st["model"], device=device)
    sync(device)
    zero_launches()
    t0 = time.perf_counter()
    predict.predict_patients(st["model"], st["ctx"], st["X"], cohort.Y, cohort.ages,
                             st["splits"]["test"])
    sync(device)
    dt = time.perf_counter() - t0
    launches = launch_counts()
    n_b = -(-len(st["splits"]["test"]) // cfg.batch_size)
    ok = (cli_res["prob"] == mem["prob"] and cli_res["auc"] == mem["auc"]
          and launches[k1.KERNEL.name] > 0 and launches[k3.KERNEL.name] == 0)
    emit({"phase": "predict", "fold": 2, "patients": len(mem["prob"]), "batches": n_b,
          "batch_size": cfg.batch_size, "ms_per_batch": dt * 1e3 / n_b,
          "launches_per_batch": {k: v / n_b for k, v in launches.items()},
          "windowed": st["ctx"].graph.winplan is not None,
          "auc": mem["auc"], "cli_equals_in_memory": ok, "ok": ok})
    if not ok:
        raise AssertionError("predict: the CLI's scores differ from the in-memory ones")
    return launches


def explain_cli_phase(root, ckpt_dir, device="cuda"):
    """The explain CLI once on fold 0's checkpoint (its test split in
    chunks of 32, IG_STEPS steps), launches counted."""
    from multilevel_gnn_tpu_torch.train import explain

    sync(device)
    zero_launches()
    t0 = time.perf_counter()
    res = explain.main(["--config", GBM_YAML, "--ckpt-dir", ckpt_dir, "--fold", "0",
                        "--data-dir", root, "--ig-steps", str(IG_STEPS), "--top", "3",
                        "--device", device])
    sync(device)
    dt = time.perf_counter() - t0
    launches = launch_counts()
    ok = (len(res["rows"]) > 0 and bool(np.isfinite(res["scores"]).all())
          and launches[k1.KERNEL.name] > 0)
    emit({"phase": "explain_cli", "patients": len(res["patients"]), "rows": len(res["rows"]),
          "wall_s": dt, "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError("explain CLI failed")
    return launches


# ---- the kernels as custom ops, export, warm, the profiler trace, and the
# PPI / merge graph sources
TOL_EXPORT = 1e-6  # times max(1, max|ref|): the exported call against the live one
REPO = Path(__file__).resolve().parent
PPI_EDGES = 45_000  # make_cohort_topology's e_ppi
PPI_EPOCHS = 3
# the child process that loads the artifact: load seconds (from its start,
# torch's import and CUDA's start-up included, and a second load), first-
# call seconds, probabilities, launches per call (counts zeroed just
# before one call), CUDA-event ms per call and its kernels' device ms
EXPORT_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
import numpy as np, torch
torch.cuda.init()
import_s = time.perf_counter() - t0
# the precision flags main() sets for the live call
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from multilevel_gnn_tpu_torch.artifact import load_exported
from multilevel_gnn_tpu_torch.ops.kernels import build
t1 = time.perf_counter()
infer = load_exported(sys.argv[1])
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
load_exported_s = time.perf_counter() - t1
t1 = time.perf_counter()
load_exported(sys.argv[1])
torch.cuda.synchronize()
load_again_s = time.perf_counter() - t1
z = np.load(sys.argv[2])
x = torch.as_tensor(z["x"], device="cuda")
age = torch.as_tensor(z["age"], device="cuda")
t0 = time.perf_counter()
infer(x, age)
torch.cuda.synchronize()
first_s = time.perf_counter() - t0
for k in build.REGISTRY.values():
    k.launches = 0
p = infer(x, age)
torch.cuda.synchronize()
launches = {k.name: k.launches for k in build.REGISTRY.values()}
ms = []
for _ in range(20):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record(); infer(x, age); b.record(); b.synchronize()
    ms.append(a.elapsed_time(b))
windows = []
for _ in range(3):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            infer(x, age)
        torch.cuda.synchronize()
    windows.append(sum(getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()
                       if ev.device_type == DeviceType.CUDA
                       and not getattr(ev, "is_user_annotation", False)) / 1e3 / 10)
print(json.dumps({"load_s": load_s, "import_torch_s": import_s,
                  "load_exported_s": load_exported_s, "load_again_s": load_again_s,
                  "first_call_s": first_s, "probs": p.cpu().tolist(),
                  "launches": launches, "event_ms_median": float(np.median(ms)),
                  "device_ms": float(np.median(windows))}))
"""


def _child_env():
    return dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def ops_phase(graph, gen):
    """torch.library.opcheck (schema, fake function, dispatch, the op under
    aot dispatch) of every mgtpu op on CUDA tensors over the GBM fold's
    plans, at F = 64 columns."""
    csr, wp = graph.csr, graph.winplan
    N, E = graph.n_nodes, graph.num_padded_edges

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    x = rand(N, 64)
    w = spmm.edge_weights(graph, "mean", graph.edge_attr)
    splan = k1.SortedPlan.build(graph.receivers.cpu().numpy(), N,
                                graph.edge_mask.cpu().numpy()).to("cuda")
    k1_args = (csr.rowptr, csr.col, csr.eid, csr.row, csr.items, csr.long_rows)
    res = wp.res
    cases = [
        ("segment_spmm_csr", k1.segment_spmm_csr_op, (x, w) + k1_args),
        ("segment_spmm_csr_acc", k1.segment_spmm_csr_acc_op,
         (rand(N, 64, dtype=torch.float32), x, w, res.rowptr, res.col, res.eid, res.row,
          res.items, res.long_rows, res.n_busy)),
        ("windowed_tile_spmm", k2.windowed_tile_spmm_op, (x, w) + k2._side_args(wp, False)),
        ("windowed_tile_spmm_transpose", k2.windowed_tile_spmm_op,
         (x, w) + k2._side_args(wp, True)),
        ("segment_max_csr", k3.segment_max_csr_op, (rand(E, 64), csr.rowptr, csr.eid, csr.row)),
        ("sorted_segment_sum", k1.sorted_segment_sum_op,
         (rand(2, E, 16), splan.rowptr, None, splan.seg)),
        ("sorted_segment_sum_perm", k1.sorted_segment_sum_op,
         (rand(2, E, 16), splan.rowptr, splan.perm, splan.seg)),
    ]
    seconds = {}
    for name, op, args in cases:
        t0 = time.perf_counter()
        torch.library.opcheck(op, args)  # raises on a failed check
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    emit({"phase": "ops", "checked": list(seconds), "seconds": seconds, "ok": True})


def export_phase(model, ctx, batch, phase="export", want=None):
    """A GBM fold's eval forward exported (torch.export), saved, and loaded
    in a fresh process: its probabilities against the live eval_step on
    the same batch, its launches per call against the live call's (want:
    K1 2 / K2 2, sage's, when None), the artifact's bytes, load and
    first-call seconds, and the device ms of an exported call against a
    live one."""
    from multilevel_gnn_tpu_torch.train.export import export_program, save_exported

    B, n_nodes = batch.x.shape
    t0 = time.perf_counter()
    program = export_program(copy.deepcopy(model), ctx, B, n_nodes)
    export_s = time.perf_counter() - t0
    targets = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    meta = {"batch_size": B, "n_nodes": n_nodes, "platforms": ["cuda"], "run": 0, "fold": 0,
            "n_tensors": len(program.state_dict) + len(program.constants),
            "cancer_type": "gbm", "model": "multilevel_gnn"}
    eval_step(model, batch, ctx)
    torch.cuda.synchronize()
    zero_launches()
    live = eval_step(model, batch, ctx)[0]
    torch.cuda.synchronize()
    live_launches = launch_counts()
    live_event_ms = cuda_ms(lambda: eval_step(model, batch, ctx))
    live_device_ms = device_ms(lambda: eval_step(model, batch, ctx))
    with tempfile.TemporaryDirectory() as root:
        out = f"{root}/export"
        save_exported(out, {"program": program, "meta": meta})
        del program
        artifact_bytes = _dir_bytes(out)
        np.savez(f"{root}/inputs.npz", x=batch.x.cpu().numpy(), age=batch.age.cpu().numpy())
        r = subprocess.run([sys.executable, "-c", EXPORT_CHILD, out, f"{root}/inputs.npz"],
                           capture_output=True, text=True, env=_child_env(), timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"export: the artifact's process failed:\n{r.stderr[-4000:]}")
    child = _last_json(r.stdout)
    ref = live.cpu().numpy()
    got = np.asarray(child["probs"])
    err = float(np.abs(got - ref).max())
    lim = TOL_EXPORT * max(1.0, float(np.abs(ref).max()))
    want = want or {k1.KERNEL.name: 2, k2.KERNEL.name: 2, k3.KERNEL.name: 0, k4.name: 0}
    ok = (got.shape == ref.shape and err <= lim and child["launches"] == live_launches
          and live_launches == want)
    emit({"phase": phase, "gnn_name": model.cfg.gnn_name, "n_nodes": n_nodes, "n_edges": ctx.graph.n_edges, "batch": B,
          "export_s": export_s, "artifact_bytes": artifact_bytes,
          "n_tensors": meta["n_tensors"],
          "load_s": child["load_s"], "import_torch_s": child["import_torch_s"],
          "load_exported_s": child["load_exported_s"],
          "load_again_s": child["load_again_s"], "first_call_s": child["first_call_s"],
          "max_abs_err": err, "tol": lim, "equal_bits": bool(np.array_equal(got, ref)),
          "launches_per_call": child["launches"], "live_launches_per_call": live_launches,
          "event_ms": child["event_ms_median"], "live_event_ms": live_event_ms,
          "device_ms": child["device_ms"], "live_device_ms": live_device_ms,
          "mgtpu_ops_in_graph": {k: v for k, v in targets.items() if "mgtpu" in k},
          "auto_functionalized_nodes": sum(v for k, v in targets.items()
                                           if "auto_functionalized" in k),
          "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: the exported call differs from the live one")
    return child["launches"]


def warm_phase():
    """The warm CLI in a fresh copy of the package (nothing built), then
    the train CLI from the same copy: it must find every kernel and data
    library built (0.0 s each)."""
    import shutil

    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(REPO / "multilevel_gnn_tpu_torch", Path(tmp) / "multilevel_gnn_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        env = dict(os.environ, PYTHONPATH=tmp)
        args = ["--config", GBM_YAML, "--synthetic", "--debug"]
        out = {}
        for name, module in (("warm", "multilevel_gnn_tpu_torch.train.warm"),
                             ("train", "multilevel_gnn_tpu_torch.train.cli")):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                               text=True, env=env, timeout=600, cwd=tmp)
            if r.returncode != 0:
                raise AssertionError(f"warm: {module} failed:\n{r.stderr[-4000:]}")
            out[name] = (_last_json(r.stdout), time.perf_counter() - t0)
    warm, warm_wall = out["warm"]
    train, train_wall = out["train"]
    libs = set(build.REGISTRY) | {"mi_knn", "csv_float"}
    ok = (set(train["builds"]) == libs and all(v == 0.0 for v in train["builds"].values())
          and libs <= set(warm["builds"])
          and all(warm["builds"][k] > 0 for k in build.REGISTRY))
    emit({"phase": "warm", "warm_s": warm["warm_s"], "warm_builds": warm["builds"],
          "warm_process_s": warm_wall, "next_train_builds": train["builds"],
          "next_train_process_s": train_wall, "ok": ok})
    if not ok:
        raise AssertionError("warm: the next process still had something to build")


def profile_phase(root):
    """The train CLI with --profile-dir on the protocol files (1 run x 5
    folds x 2 epochs) against the same protocol without it: the trace's
    bytes and K1's kernel symbol in it, and both wall times."""
    from multilevel_gnn_tpu_torch.train import cli
    from multilevel_gnn_tpu_torch.utils.profiling import TRACE_FILE

    args = ["--config", GBM_YAML, "--data-dir", root, "--set", "num_run=1", "epochs=2"]
    walls = {}
    for name, extra in (("plain", []), ("profiled", ["--profile-dir", f"{root}/prof"]),
                        ("plain_again", [])):
        sync("cuda")
        t0 = time.perf_counter()
        cli.main(args + extra)
        sync("cuda")
        walls[name] = time.perf_counter() - t0
    trace = Path(root) / "prof" / TRACE_FILE
    text = trace.read_text()
    ok = SYMBOLS["segment_spmm_csr"][0] in text
    emit({"phase": "profile_cli", "trace_bytes": trace.stat().st_size, "wall_s": walls,
          "names_k1": ok, "names_k2": any(s in text for s in SYMBOLS["windowed_tile_spmm"]),
          "ok": ok})
    trace.unlink()
    if not ok:
        raise AssertionError("profile: the trace does not name K1's kernel")


def expected_step_launches(ctx, n_layers):
    """Kernel launches of one sage train step from the fold's plans: per
    layer and graph, K2 forward and transpose plus K1 over each non-empty
    residual plan on a windowed graph, K1 over csr and csc on a composed
    one; and the PCA gather's backward (K1)."""
    want = {k1.KERNEL.name: 1, k2.KERNEL.name: 0, k3.KERNEL.name: 0, k4.name: 0}
    for g in (ctx.graph, ctx.graph2):
        if g is None:
            continue
        wp = g.winplan
        if wp is None:
            want[k1.KERNEL.name] += 2 * n_layers
        else:
            want[k2.KERNEL.name] += 2 * n_layers
            want[k1.KERNEL.name] += n_layers * sum(
                int(p.nnz > 0) for p in (wp.res, wp.tres, wp.res_csc))
    return want


def graph_source_phase(edge_type, root, small_root):
    """edge_type ppi or merge at reference scale from STRING tables: the
    train CLI's protocol (1 run x 5 folds x PPI_EPOCHS epochs, gbm.yaml's
    widths, bf16), counted; each fold's edges, path and derivation seconds;
    one batch's train step (kernel ms, launches per step as the plans
    predict); then a small protocol (f32, dropout off, 2 epochs) on the card
    and on the CPU, fold test scores within TOL_PROTOCOL."""
    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.data.loaders import load_cohort_from_files
    from multilevel_gnn_tpu_torch.train import cli, driver

    sets = [f"edge_type={edge_type}", "edge_path=./data/{}/ppi_edges.csv"]
    if edge_type == "merge":
        sets.append("grn_edge_path=./data/{}/grn_edges.tsv")
    sync("cuda")
    zero_launches()
    t0 = time.perf_counter()
    res = cli.main(["--config", GBM_YAML, "--data-dir", root, "--set", "num_run=1",
                    f"epochs={PPI_EPOCHS}", *sets])
    sync("cuda")
    wall = time.perf_counter() - t0
    launches = launch_counts()
    folds = res["folds"]

    def paths(d):
        return dict(
            mrna_path=f"{d}/gbm/raw_mrna.csv", cnv_path=f"{d}/gbm/raw_cnv.csv",
            methylation_path=f"{d}/gbm/raw_methylation.csv",
            clinical_path=f"{d}/gbm/clinical.pkl", kegg_path=f"{d}/kegg.csv",
            pathway_list_path=f"{d}/pathways.txt", edge_path=f"{d}/gbm/ppi_edges.csv",
            ppi_node_path=f"{d}/node.csv",
            grn_edge_path=f"{d}/gbm/grn_edges.tsv" if edge_type == "merge" else None)

    # one batch's train step on fold 0 of the same files
    cfg = Config.from_yaml(GBM_YAML, edge_type=edge_type)
    cohort = load_cohort_from_files(cfg=cfg, **paths(root))
    tr, _, _ = driver.fold_indices(cohort.labels(), cfg, 0)
    fcfg, fold, X = driver.fold_setup(cfg, cohort, tr, 0, "cuda")
    fcfg = fcfg.replace(pathway_num=cohort.n_pathways)
    model = driver._new_model(fcfg, fold.ctx, 0)
    batch = next(iter_batches(X, cohort.Y, cohort.ages, tr, fcfg.batch_size, "cuda"))
    cw = torch.as_tensor(fold.class_weight, dtype=torch.float32, device="cuda")
    want = expected_step_launches(fold.ctx, model.n_layers)
    per_step, kernel_ms = profile_train(model, fold.ctx, batch, cw, want,
                                        phase=f"profile_train_{edge_type}")
    g2 = fold.ctx.graph2
    del model, fold, cohort
    torch.cuda.empty_cache()

    # the small protocol, card against CPU
    scfg = Config.from_yaml(GBM_YAML).replace(
        edge_type=edge_type, num_run=1, epochs=2, compute_dtype=None, spmm_bf16=False,
        feature_drop=False, head_drop_rate=0.0, gnn_dropout=0.0)
    scores = {}
    for dev in ("cuda", "cpu"):
        small = load_cohort_from_files(cfg=scfg, **paths(small_root))
        rec, undo = _spy_folds()
        try:
            out = driver.run_experiment(scfg, small, device=dev)
        finally:
            undo()
        scores[dev] = (rec, out)
    errs = [max(float(np.abs(a.epoch_pred[2] - b.epoch_pred[2]).max()),
                float(np.abs(a.epoch_pred_by_epoch[2] - b.epoch_pred_by_epoch[2]).max()))
            for a, b in zip(scores["cuda"][0], scores["cpu"][0])]
    ok = bool(len(folds) == 5 and launches[k1.KERNEL.name] > 0
              and (launches[k2.KERNEL.name] > 0) == any(f["windowed"] for f in folds)
              and launches[k3.KERNEL.name] == 0 and len(errs) == 5
              and max(errs) <= TOL_PROTOCOL
              and (g2 is not None) == (edge_type == "merge"))
    emit({"phase": edge_type, "wall_s": wall, "cli_wall_time_s": res["wall_time_s"],
          "edges": [f["edges"] for f in folds], "windowed": [f["windowed"] for f in folds],
          "windowed_min_edges": cfg.windowed_min_edges,
          "graph2_edges": None if g2 is None else int(g2.n_edges),
          "fold_setup_s": [f["setup_s"] for f in folds],
          "fold_stage_s": [f["setup_stage_s"] for f in folds],
          "ms_per_step_median": [f["step_ms_median"] for f in folds],
          "launches": launches, "step_kernel_ms": kernel_ms,
          "launches_per_step": per_step, "pooled_auc": res["auc"][res["check_epochs"][-1]],
          "small_fold_max_abs_err": errs, "tol": TOL_PROTOCOL,
          "small_pooled_auc_cuda": scores["cuda"][1]["auc"][2],
          "small_pooled_auc_cpu": scores["cpu"][1]["auc"][2], "ok": ok})
    if not ok:
        raise AssertionError(f"{edge_type} phase failed")
    return launches


# ---- DeeperGCN on the gene-level fold graph (gbm.yaml with model=deepergcn,
# hidden_channels=128, num_layers=3: gcn_aggr max, norm layer, block res+,
# maxpool readout, bf16 trunk)
DGCN_SETS = ("model=deepergcn", "hidden_channels=128", "num_layers=3")
# kernels against plain versions through the whole eval forward: max runs K3
# only, which selects one of its inputs (equal); softmax adds K1's sums in
# another order, which a bf16 cast can move by an ulp
TOL_PROB_DGCN = {"f32": 1e-5, "bf16": 5e-3}
# one step's gradients, kernels against plain versions: bf16 as TOL_GRAD;
# f32 at K1's own limit (TOL_F32): the edge-id table's gradient sums every
# gene edge's cotangent into row 0 (about 120k rows, K1's long-row blocks
# against index_add_), read 9.1e-6 on an H100 where sage's step reads 6e-7
TOL_GRAD_DGCN = {"bf16": 7e-2, "f32": TOL_F32}
DGCN_EPOCHS = 3


def dgcn_cfg(**kw):
    from multilevel_gnn_tpu_torch.core.config import Config

    return Config.from_yaml(GBM_YAML, model="deepergcn", hidden_channels=128,
                            num_layers=3, **kw)


def dgcn_fold_phase(cohort):
    """fold 0's gene-level graph through fold_setup, timed by stage."""
    from multilevel_gnn_tpu_torch.train import driver

    cfg = dgcn_cfg()
    tr, va, te = driver.fold_indices(cohort.labels(), cfg, 0)
    t0 = time.perf_counter()
    fcfg, fold, X = driver.fold_setup(cfg, cohort, tr, 0, "cuda")
    sync("cuda")
    setup_s = time.perf_counter() - t0
    fcfg = fcfg.replace(pathway_num=cohort.n_pathways)
    g = fold.ctx.graph
    deg = g.in_degree()
    ok = bool(g.n_nodes == cohort.node_size + cohort.n_pathways and g.n_edges > 0
              and fcfg.pathway_edge_num == cohort.pathway_edge_num > 0
              and X.shape == (len(cohort.patients), g.n_nodes, 3))
    emit({"phase": "deepergcn_fold", "n_nodes": g.n_nodes, "n_genes": cohort.node_size,
          "pathways": cohort.n_pathways, "edges": g.n_edges,
          "pathway_edge_num": cohort.pathway_edge_num,
          "max_in_degree": int(deg.max()), "rows_without_in_edges": int((deg == 0).sum()),
          "setup_s": setup_s, "stage_s": fold.seconds, "ok": ok})
    if not ok:
        raise AssertionError("deepergcn_fold phase failed")
    return fcfg, fold, X, (tr, va, te)


def dgcn_kernel_phase(ctx, B, H, gen):
    """K3 on the fold's receivers at F = B*H and 2*B*H (kirc / lgg's B),
    bf16 and f32 (equal to plain); K1 as edge_segment_sum's forward (unit
    weights over dst_gather) and as gather_src's backward (over
    src_gather) at F = B*H, bf16 and f32; K1 as the edge-id lookup's
    backward (over edge_id_gather: every gene edge's row into table row 0)
    on the (E, H) f32 cotangent, with index_add_ as its library call."""
    r3, r1 = {}, {}
    graph = ctx.graph
    E = graph.num_padded_edges
    for F in (B * H, 2 * B * H):
        for dt in (torch.bfloat16, torch.float32):
            msg = torch.randn(E, F, generator=gen, device="cuda").to(dt)
            r = time_k3(graph, msg)
            emit({"phase": "k3_gene", **r})
            r3[(F, r["dtype"])] = r
            del msg
            torch.cuda.empty_cache()
    ones = torch.ones(E, device="cuda")
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(E, B * H, generator=gen, device="cuda").to(dt)
        for case, plan in (("edge_segment_sum", graph.dst_gather),
                           ("gather_src_bwd", graph.src_gather)):
            r = time_k1(case, plan, x, ones, False, gen)
            emit({"phase": "k1_gene", **r})
            r1[(case, r["dtype"])] = r
        del x
        torch.cuda.empty_cache()
    plan, ids = ctx.edge_id_gather, ctx.edge_ids.long()
    g = torch.randn(ids.shape[0], H, generator=gen, device="cuda")

    def index_add():
        return torch.zeros(plan.n_rows, H, device="cuda").index_add_(0, ids, g)

    r = time_k1("edge_id_lookup_bwd", plan, g, torch.ones(ids.shape[0], device="cuda"),
                False, gen, library=index_add)
    emit({"phase": "k1_gene", **r, "rows": plan.n_rows,
          "largest_row": int(torch.bincount(ids).max())})
    r1[("edge_id_lookup_bwd", r["dtype"])] = r
    return r3, r1


def dgcn_batch(X, raw, cohort, idx, B):
    from multilevel_gnn_tpu_torch.train.driver import iter_batches

    return next(iter_batches(X, cohort.Y, cohort.ages, idx, B, "cuda", raw))


def dgcn_slice_phase(fcfg, ctx, batch):
    """The eval forward with kernels against plain versions on the card, for
    gcn_aggr max and softmax, bf16 and f32 trunks."""
    from multilevel_gnn_tpu_torch.models.deepergcn import DeeperGCN

    for aggr in ("max", "softmax"):
        for trunk in ("bf16", "f32"):
            cfg = fcfg.replace(gcn_aggr=aggr,
                               compute_dtype="bfloat16" if trunk == "bf16" else None)
            m = DeeperGCN(cfg, device="cuda", seed=0).eval()
            with torch.no_grad():
                pk = m(batch, ctx)[0]
                with spmm.plain_versions():
                    pp = m(batch, ctx)[0]
            torch.cuda.synchronize()
            e = float((pk - pp).abs().max())
            tol = 0.0 if aggr == "max" else TOL_PROB_DGCN[trunk]
            finite = bool(torch.isfinite(pk).all())
            ok = finite and e <= tol and float((pk.sum(-1) - 1).abs().max()) < 1e-5
            emit({"phase": "slice_deepergcn", "aggr": aggr, "trunk": trunk,
                  "max_abs_err_prob": e, "tol": tol, "finite": finite,
                  "shape": list(pk.shape), "ok": ok})
            if not ok:
                raise AssertionError(f"slice_deepergcn {aggr} {trunk} mismatch")
            del m


def dgcn_serve_phase(model, ctx, X, raw, cohort, n_batches):
    """predict_patients over N_PATIENTS, counted: K3 once a layer a batch,
    no K1 or K2 (the gathers' forwards are index_select)."""
    idx = np.arange(N_PATIENTS)
    predict_patients(model, ctx, X, cohort.Y, cohort.ages, idx, raw)  # warm-up
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    res = predict_patients(model, ctx, X, cohort.Y, cohort.ages, idx, raw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    L = model.cfg.num_layers
    want = {k1.KERNEL.name: 0, k2.KERNEL.name: 0, k3.KERNEL.name: L * n_batches,
            k4.name: 0}
    prob = np.asarray(res["prob"])
    ok = (len(prob) == N_PATIENTS and bool(np.isfinite(prob).all())
          and bool(((prob >= 0) & (prob <= 1)).all()) and launches == want)
    emit({"phase": "serve_deepergcn", "batches": n_batches, "patients": N_PATIENTS,
          "ms_per_batch": dt * 1e3 / n_batches, "launches": launches,
          "launches_expected": want, "auc": res["auc"], "loss": res["loss"], "ok": ok})
    if not ok:
        raise AssertionError("serve_deepergcn phase failed")
    return launches


def dgcn_experiment_phase(root):
    """The train CLI's main with --set model=deepergcn hidden_channels=128
    num_layers=3 on the protocol files, 1 run x 5 folds x DGCN_EPOCHS
    epochs, bf16, counted, peak memory; then a small protocol (f32,
    dropout off, 2 epochs) on the card and on the CPU, with gcn_aggr
    softmax and max, fold test scores within TOL_PROTOCOL."""
    from multilevel_gnn_tpu_torch.data.synthetic import make_synthetic_cohort
    from multilevel_gnn_tpu_torch.train import cli, driver

    sync("cuda")
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    res = cli.main(["--config", GBM_YAML, "--data-dir", root, "--set", *DGCN_SETS,
                    "num_run=1", f"epochs={DGCN_EPOCHS}"])
    sync("cuda")
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    folds = res["folds"]
    e = res["check_epochs"][-1]
    auc, acc = res["auc"][e], res["acc"][e]
    ok = bool(len(folds) == 5 and launches[k1.KERNEL.name] > 0
              and launches[k3.KERNEL.name] > 0 and launches[k2.KERNEL.name] == 0
              and launches[k4.name] == 0 and 0.0 <= auc <= 1.0 and 0.0 <= acc <= 1.0)
    emit({"phase": "experiment_deepergcn", "wall_s": wall,
          "cli_wall_time_s": res["wall_time_s"],
          "fold_setup_s": [f["setup_s"] for f in folds],
          "fold_stage_s": [f["setup_stage_s"] for f in folds],
          "edges": [f["edges"] for f in folds],
          "ms_per_step_median": [f["step_ms_median"] for f in folds],
          "host_s_per_epoch": [f["epoch_s"] for f in folds], "launches": launches,
          "pooled_auc": auc, "pooled_acc": acc, "peak_mem_gb": peak, "ok": ok})
    if not ok:
        raise AssertionError("experiment_deepergcn phase failed")
    for aggr in ("softmax", "max"):
        cfg = dgcn_cfg(num_run=1, epochs=2, compute_dtype=None, spmm_bf16=False,
                       feature_drop=False, dropout=0.0, gcn_aggr=aggr)
        scores = {}
        for dev in ("cuda", "cpu"):
            cohort = make_synthetic_cohort(cfg, **SMALL_COHORT)
            rec, undo = _spy_folds()
            try:
                out = driver.run_experiment(cfg, cohort, device=dev)
            finally:
                undo()
            scores[dev] = (rec, out)
        errs = [max(float(np.abs(a.epoch_pred[2] - b.epoch_pred[2]).max()),
                    float(np.abs(a.epoch_pred_by_epoch[2] - b.epoch_pred_by_epoch[2]).max()))
                for a, b in zip(scores["cuda"][0], scores["cpu"][0])]
        ok = len(errs) == 5 and max(errs) <= TOL_PROTOCOL
        emit({"phase": "experiment_deepergcn_small_vs_cpu", "aggr": aggr,
              "fold_max_abs_err": errs, "tol": TOL_PROTOCOL,
              "pooled_auc_cuda": scores["cuda"][1]["auc"][2],
              "pooled_auc_cpu": scores["cpu"][1]["auc"][2], "ok": ok})
        if not ok:
            raise AssertionError(f"small deepergcn protocol ({aggr}): card vs CPU mismatch")
    return launches, peak


def deepergcn_phases(root, cohort, gen):
    """Every DeeperGCN phase on the protocol files' cohort.  Returns the
    serving and experiment launch counts, the train step's launches, and
    the K3 / K1 gene-width forms."""
    from multilevel_gnn_tpu_torch.models.deepergcn import DeeperGCN
    from multilevel_gnn_tpu_torch.train import driver

    fcfg, fold, X, (tr, va, te) = dgcn_fold_phase(cohort)
    ctx, raw = fold.ctx, fold.raw
    B, H = fcfg.batch_size, fcfg.hidden_channels
    r3, r1 = dgcn_kernel_phase(ctx, B, H, gen)
    batch = dgcn_batch(X, raw, cohort, tr, B)
    dgcn_slice_phase(fcfg, ctx, batch)
    model = driver._new_model(fcfg, ctx, 0)
    serve = dgcn_serve_phase(model, ctx, X, raw, cohort, -(-N_PATIENTS // B))
    profile_eval(model, ctx, batch, "profile_deepergcn")
    cw = torch.as_tensor(fold.class_weight, dtype=torch.float32, device="cuda")
    train_grad_checks((("bf16", model),), ctx, batch, cw, phase="train_grad_deepergcn",
                      tol=TOL_GRAD_DGCN)
    m32 = driver._new_model(fcfg.replace(compute_dtype=None), ctx, 0)
    train_grad_checks((("f32", m32),), ctx, batch, cw, phase="train_grad_deepergcn",
                      tol=TOL_GRAD_DGCN)
    del m32
    # a step: K3 once a layer (forward); K1 as each layer's gather_src
    # backward and once as the edge-id lookup's backward
    L = fcfg.num_layers
    want_step = {k1.KERNEL.name: L + 1, k2.KERNEL.name: 0, k3.KERNEL.name: L, k4.name: 0}
    torch.cuda.reset_peak_memory_stats()
    per_step, step_kernel_ms = profile_train(model, ctx, batch, cw, want_step,
                                             phase="profile_train_deepergcn")
    emit({"phase": "train_mem_deepergcn", "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "edge_tensor_gb": ctx.graph.num_padded_edges * B * H * 2 / 1e9})
    del model, fold, ctx, batch
    torch.cuda.empty_cache()
    experiment, peak = dgcn_experiment_phase(root)
    torch.cuda.empty_cache()
    return dict(serve=serve, experiment=experiment, per_step=per_step, r3=r3, r1=r1,
                step_kernel_ms=step_kernel_ms)


# ---- PathCNN, the pretraining models and the VAE classifier on the GBM fold
PRETRAIN_STEPS = 5  # timed and counted steps of each pretraining model
# the VAE classifier reads mu only: its enc_log_sigma has no gradient
VAE_FINETUNE_NO_GRAD = frozenset({"enc_log_sigma.weight", "enc_log_sigma.bias"})
# PathCNN on a small fold, the card against the CPU (f32): the probabilities
# (TOL_PROB_CPU), the image, and the VJP's gradients at a fixed cotangent in
# eval mode (the dropout masks come from each device's generator), times
# max(1, max|ref|).  Its softmax saturates (the raw age enters the head), so
# the loss's own gradient would measure f32 rounding, not the port (R6).
TOL_CPU_PATHCNN = 1e-4


def zero_counts():
    return {k: 0 for k in launch_counts()}


def serve_counted(model, ctx, X, Y, ages, raw=None):
    """predict_patients over N_PATIENTS, warmed up, then counted and timed."""
    idx = np.arange(N_PATIENTS)
    predict_patients(model, ctx, X, Y, ages, idx, raw)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    res = predict_patients(model, ctx, X, Y, ages, idx, raw)
    torch.cuda.synchronize()
    prob = np.asarray(res["prob"])
    ok = (len(prob) == N_PATIENTS and bool(np.isfinite(prob).all())
          and bool(((prob >= 0) & (prob <= 1)).all()) and np.isfinite(res["loss"]))
    return res, launch_counts(), time.perf_counter() - t0, ok


def pathcnn_vs_cpu():
    """A small fold's PathCNN (learnable PCA) on the card against the CPU."""
    from multilevel_gnn_tpu_torch.models.pathcnn import PathCNN

    rng = np.random.RandomState(8)
    raw = (rng.randn(8, 900) * 0.5).astype(np.float32)
    res = {}
    for dev in ("cuda", "cpu"):
        cfg, _, _, c, b = make_gbm_scale_setup(node_num=300, n_pathways=12, batch=8,
                                               gene_rows=900, topology="cohort", device=dev)
        m = PathCNN(cfg.replace(model="pathcnn", learnable_pca=True), c.graph.n_nodes,
                    c.num_pca_rows, device=dev, seed=0)
        m.eval()
        b = dataclasses.replace(b, raw_data=torch.as_tensor(raw, device=dev))
        pred, img = m(b, c)
        cot = np.random.RandomState(9)
        torch.autograd.backward([pred, img], [
            torch.as_tensor(cot.randn(*pred.shape).astype(np.float32), device=dev),
            torch.as_tensor(cot.randn(*img.shape).astype(np.float32), device=dev)])
        res[dev] = (pred.detach().cpu(), img.detach().cpu(),
                    {n: p.grad.cpu() for n, p in m.named_parameters()})
    (pc, ic, gc), (pp, ip, gp) = res["cuda"], res["cpu"]
    e_prob = float((pc - pp).abs().max())
    e_img = err_of(ic, ip)[0] / max(1.0, float(ip.abs().max()))
    e_grad = {n: float((gc[n] - g).abs().max()) / max(1.0, float(g.abs().max()))
              for n, g in gp.items()}
    ok = e_prob <= TOL_PROB_CPU and e_img <= TOL_CPU_PATHCNN and max(e_grad.values()) <= TOL_CPU_PATHCNN
    emit({"phase": "pathcnn_vs_cpu", "max_abs_err_prob": e_prob, "tol_prob": TOL_PROB_CPU,
          "rel_err_image": e_img, "rel_err_grad_by_param": e_grad, "tol": TOL_CPU_PATHCNN,
          "ok": ok})
    if not ok:
        raise AssertionError("pathcnn: card vs CPU mismatch")


def pathcnn_phase(cfg, ctx):
    """PathCNN at gbm.yaml's widths on the GBM fold, with learnable PCA on
    the PCA-row values (G = 25,015) and on the precomputed pathway attrs:
    serving the N_PATIENTS and PRETRAIN_STEPS train steps, each counted (no
    port kernel: the contraction is the dense pathway product)."""
    from multilevel_gnn_tpu_torch.models.pathcnn import PathCNN

    n, G = ctx.graph.n_nodes, ctx.num_pca_rows
    X, Y, ages = patients(n)
    rng = np.random.RandomState(4)
    cw = torch.tensor([1.0, 1.5], device="cuda")
    out = {}
    for learnable, name in ((True, "pathcnn"), (False, "pathcnn_attrs")):
        pcfg = cfg.replace(model="pathcnn", learnable_pca=learnable)
        width = G if learnable else cfg.pathway_num * 3 * cfg.pca_dim
        raw = (rng.randn(N_PATIENTS, width) * 0.5).astype(np.float32)
        model = PathCNN(pcfg, n, G, device="cuda", seed=0)
        res, serve, dt, ok = serve_counted(model, ctx, X, Y, ages, raw)
        batch = next(iter_batches(X, Y, ages, np.arange(cfg.batch_size), cfg.batch_size,
                                  "cuda", raw))
        eval_ms = cuda_ms(lambda: eval_step(model, batch, ctx))
        eval_kms = profiled(lambda: eval_step(model, batch, ctx))[0]
        opt = make_optimizer(model, pcfg, 4)
        gen = torch.Generator(device="cuda").manual_seed(0)
        losses = []
        ms, per_step = timed_steps(
            lambda: losses.append(train_step(model, opt, batch, ctx, cw, gen)), PRETRAIN_STEPS)
        kms, n_k, rows = profiled(lambda: train_step(model, opt, batch, ctx, cw, gen))
        losses = [float(v) for v in losses]
        ok = ok and serve == zero_counts() and per_step == zero_counts() and bool(
            np.isfinite(losses).all())
        emit({"phase": name, "patients": N_PATIENTS, "serve_ms_per_batch": dt * 1e3 / 4,
              "eval_step_ms": eval_ms, "eval_kernel_ms": eval_kms,
              "launches_serve": serve, "step_ms": ms, "step_ms_median": float(np.median(ms)),
              "kernel_ms_per_step": kms, "kernels_per_step": n_k,
              "gap_share": 1 - kms / float(np.median(ms)), "top": top_rows(rows, 8),
              "launches_per_step": per_step,
              "losses": losses, "auc": res["auc"], "ok": ok})
        if not ok:
            raise AssertionError(f"{name} phase failed")
        out[name] = (serve, per_step)
        del model, opt
    pathcnn_vs_cpu()
    return out


def seed_codebook(model, batch, ctx):
    """The codebook set to rows of another batch's latent (patients of
    seed 7, eval mode, kernels), so that many codes compete for each latent
    row: at init every latent is nearest to one code."""
    x = torch.as_tensor(patients(batch.x.shape[1], n=batch.x.shape[0], seed=7)[0],
                        device="cuda").to(batch.x.dtype)
    cb = model.quantizer.embedding
    with torch.no_grad():
        model.eval()
        z = model(dataclasses.replace(batch, x=x), ctx)["z"].reshape(-1, cb.shape[1])
        rows = np.random.RandomState(7).choice(z.shape[0], cb.shape[0], replace=False)
        cb.copy_(z[torch.as_tensor(rows, device="cuda")].float())


def vq_flips(model, batch, ctx):
    """The nearest codes of the kernels' latent against the plain versions'
    (eval mode).  A row whose code differs (a flip) is explained when the
    kernels' distance gap between the two codes is within what the latent's
    difference can move it, 2 |z_k - z_p| |c_k - c_p|, plus the f32
    rounding of the two distances.  closest_tie: the smallest gap between
    a row's nearest and second-nearest code (kernels)."""
    cb = model.quantizer.embedding

    def dist(z):
        f = z.reshape(-1, z.shape[-1]).float()
        return f, (f ** 2).sum(1, keepdim=True) + (cb ** 2).sum(1)[None] - 2.0 * f @ cb.T

    with torch.no_grad():
        model.eval()
        fk, dk = dist(model(batch, ctx)["z"])
        with spmm.plain_versions():
            fp, dp = dist(model(batch, ctx)["z"])
        ck, cp = dk.argmin(1), dp.argmin(1)
        two = dk.topk(2, dim=1, largest=False).values
        tie = float((two[:, 1] - two[:, 0]).min())
        rows = torch.nonzero(ck != cp).flatten()
        gap = dk[rows, cp[rows]] - dk[rows, ck[rows]]
        reach = (2.0 * (fk[rows] - fp[rows]).norm(dim=1) * (cb[ck[rows]] - cb[cp[rows]]).norm(dim=1)
                 + 4e-7 * ((fk[rows] ** 2).sum(1) + (cb[ck[rows]] ** 2).sum(1)
                           + (cb[cp[rows]] ** 2).sum(1)))
    each = [{"row": int(r), "code": int(ck[r]), "code_plain": int(cp[r]),
             "distance_gap": float(g), "reach": float(m)}
            for r, g, m in zip(rows.tolist(), gap.tolist(), reach.tolist())]
    return {"flips": len(each), "rows": int(ck.numel()), "codes_used": int(ck.unique().numel()),
            "closest_tie": tie,
            "explained": bool((gap <= reach).all()), "each": each[:32],
            "codes_flipped": sorted(set(ck[rows].tolist()) | set(cp[rows].tolist()))}


def pretrain_phase(kind, cfg, ctx, batch, decoder="flatten", n_steps=PRETRAIN_STEPS):
    """One pretraining model at gbm.yaml's widths on the GBM fold (bf16
    trunk): a loss's gradients with the kernels against the plain versions
    (the VAE's draws shared; the VQ codes compared, any flip reported with
    its distance gap), then n_steps pretrain steps counted and timed, and
    the peak memory."""
    from multilevel_gnn_tpu_torch.train import pretrain as P

    n, G, B = ctx.graph.n_nodes, ctx.num_pca_rows, cfg.batch_size
    sizes = tuple(int(c) for c in torch.bincount(
        ctx.raw_indice, minlength=3 * cfg.pathway_num).cpu())
    kcfg = cfg.replace(model=kind, decoder_type=decoder, slot_sizes=sizes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = P.KINDS[kind](kcfg, n, G, device="cuda", seed=0)
    n_dec = sum(p.numel() for name, p in model.named_parameters() if name.startswith("dec_"))
    rng = np.random.RandomState(5)
    b = dataclasses.replace(batch, raw_data=torch.as_tensor(
        (rng.randn(B, G) * 0.5).astype(np.float32), device="cuda"))
    std_w = torch.as_tensor(rng.rand(G).astype(np.float32) + 0.5, device="cuda")
    S, H = model.latent_shape(cfg.final_channels)
    g = torch.Generator(device="cuda").manual_seed(6)
    eps = torch.randn((B, S, H), generator=g, device="cuda")
    prior = torch.randn((S, B, H), generator=g, device="cuda")

    def grads():
        model.train()
        model.zero_grad(set_to_none=True)
        loss, parts = P.pretrain_loss(model, kind, b, ctx, std_w, eps=eps, prior=prior)
        loss.backward()
        return float(loss.detach()), {nm: p.grad.clone()
                                      for nm, p in model.named_parameters()}, parts

    flips = None
    if kind == "vq_vae":
        seed_codebook(model, b, ctx)
        flips = vq_flips(model, b, ctx)
    lk, gk, pk = grads()
    with spmm.plain_versions():
        lp, gp, pp = grads()
    model.zero_grad(set_to_none=True)
    if flips is not None:
        # a flipped latent moves its codebook gradient from one code to the
        # other: those codes' rows are compared only through the flip report
        keep = torch.ones(gk["quantizer.embedding"].shape[0], dtype=torch.bool, device="cuda")
        keep[flips["codes_flipped"]] = False
        gk["quantizer.embedding"] = gk["quantizer.embedding"][keep]
        gp["quantizer.embedding"] = gp["quantizer.embedding"][keep]
    rel = {nm: float((gk[nm] - gp[nm]).abs().max()) / max(float(gp[nm].abs().max()), 1e-30)
           for nm in gk}
    del gk, gp
    opt = P.make_pretrain_optimizer(model, kcfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses = []
    ms, per_step = timed_steps(
        lambda: losses.append(P.pretrain_step(model, opt, kind, b, ctx, std_w, gen)), n_steps)
    kms, n_k, rows = profiled(lambda: P.pretrain_step(model, opt, kind, b, ctx, std_w, gen),
                              min(n_steps, 3))
    losses = [float(v) for v in losses]
    want = conv_launches("sage", ctx.graph.winplan)[1]
    worst = max(rel.values())
    ok = (per_step == want and bool(np.isfinite(losses).all()) and np.isfinite(lk)
          and worst <= TOL_GRAD["bf16"] and len(set(losses)) > 1
          and (flips is None or (flips["codes_used"] > 1 and flips["explained"])))
    phase = f"pretrain_{kind}" + ("" if decoder == "flatten" else f"_{decoder}")
    emit({"phase": phase, "decoder": decoder, "decoder_params": n_dec,
          "decoder_slots": len(getattr(model, "dec_slots", [])), "loss": lk,
          "loss_plain": lp, "max_rel_err_grad": worst, "tol": TOL_GRAD["bf16"],
          "rel_err_by_param": rel, "vq_codes": flips, "step_ms": ms,
          "step_ms_median": float(np.median(ms)), "kernel_ms_per_step": kms,
          "kernels_per_step": n_k, "gap_share": 1 - kms / float(np.median(ms)), "top": top_rows(rows, 8),
          "launches_per_step": per_step,
          "launches_per_step_expected": want, "losses": losses,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "ok": ok})
    if not ok:
        raise AssertionError(f"{phase} phase failed")
    del model, opt
    torch.cuda.empty_cache()
    return per_step


def vae_finetune_phase(cfg, ctx, batch):
    """VAEClassifier at gbm.yaml's widths on the GBM fold (bf16 trunk), its
    DiffPool head over a 146 x 146 pathway adjacency (a correlation + I)
    and its ConvHead (foreach latent, so the image has 3 columns): serving
    counted, the forward and one step's gradients with kernels against
    plain versions, and train steps counted (profile_train)."""
    from multilevel_gnn_tpu_torch.models.vae import VAEClassifier

    n, G, P = ctx.graph.n_nodes, ctx.num_pca_rows, cfg.pathway_num
    corr = np.corrcoef(np.random.RandomState(6).randn(P, 64)) + np.eye(P)
    vctx = dataclasses.replace(ctx, pathway_adj=torch.as_tensor(
        corr.astype(np.float32), device="cuda"))
    X, Y, ages = patients(n)
    per_batch, want_step = conv_launches("sage", ctx.graph.winplan)
    cw = torch.tensor([1.0, 1.5], device="cuda")
    out = {}
    for head, kw in (("diff_pooling", dict(reorder_type="diff_pooling")),
                     ("conv_head", dict(decoder_type="foreach"))):
        vcfg = cfg.replace(model="vae_finetune", **kw)
        model = VAEClassifier(vcfg, n, G, device="cuda", seed=0)
        res, serve, dt, ok = serve_counted(model, vctx, X, Y, ages)
        want = {k: v * 4 for k, v in per_batch.items()}
        with torch.no_grad():
            model.eval()
            pk, ik, xk = model(batch, vctx)
            with spmm.plain_versions():
                pp, ip, xp = model(batch, vctx)
        e_prob = float((pk - pp).abs().max())
        e_img, im = err_of(ik, ip)
        ok = (ok and serve == want and e_prob <= TOL_PROB and e_img <= TOL_IMAGE_BF16 * im
              and bool(torch.isfinite(torch.as_tensor(xk)).all()))
        emit({"phase": f"vae_finetune_{head}", "serve_ms_per_batch": dt * 1e3 / 4,
              "launches_serve": serve, "launches_serve_expected": want,
              "max_abs_err_prob": e_prob, "tol_prob": TOL_PROB, "max_abs_err_image": e_img,
              "image_max": im, "tol_image": TOL_IMAGE_BF16,
              "link_entropy": float(xk), "link_entropy_plain": float(xp), "auc": res["auc"],
              "ok": ok})
        if not ok:
            raise AssertionError(f"vae_finetune_{head} phase failed")
        train_grad_checks((("bf16", model),), vctx, batch, cw,
                          phase=f"train_grad_vae_finetune_{head}", no_grad=VAE_FINETUNE_NO_GRAD)
        per_step = profile_train(model, vctx, batch, cw, want_step,
                                 phase=f"profile_train_vae_finetune_{head}")[0]
        out[head] = (serve, per_step)
        del model
        torch.cuda.empty_cache()
    return out


def pretrain_protocol_phase(small_root):
    """The train CLI with --pretrain autoencoder --pretrain-epochs 2 on the
    small reference-format files (f32, dropout off, 1 run x 5 folds x 2
    epochs), on the card and on the CPU: each fold's test scores within
    TOL_PROTOCOL, pooled AUC and ACC equal; then the pathcnn protocol on the
    card (its fixed dropouts draw from the device's generator), counted."""
    from multilevel_gnn_tpu_torch.train import cli

    sets = ["num_run=1", "epochs=2", "compute_dtype=null", "spmm_bf16=false",
            "feature_drop=false", "head_drop_rate=0.0", "gnn_dropout=0.0"]
    base = ["--config", GBM_YAML, "--data-dir", small_root]
    out = {}
    for dev in ("cuda", "cpu"):
        sync("cuda")
        zero_launches()
        rec, undo = _spy_folds()
        try:
            res = cli.main(base + ["--device", dev, "--pretrain", "autoencoder",
                                   "--pretrain-epochs", "2", "--set", *sets])
        finally:
            undo()
        sync("cuda")
        out[dev] = (rec, res, launch_counts())
    (rc, resc, launches), (rp, resp, _) = out["cuda"], out["cpu"]
    errs = [max(float(np.abs(a.epoch_pred[2] - b.epoch_pred[2]).max()),
                float(np.abs(a.epoch_pred_by_epoch[2] - b.epoch_pred_by_epoch[2]).max()))
            for a, b in zip(rc, rp)]
    ok = bool(len(errs) == 5 and max(errs) <= TOL_PROTOCOL
              and resc["auc"][2] == resp["auc"][2] and resc["acc"][2] == resp["acc"][2]
              and launches[k1.KERNEL.name] > 0 and launches[k2.KERNEL.name] == 0
              and launches[k3.KERNEL.name] == 0)
    emit({"phase": "pretrain_protocol_vs_cpu", "fold_max_abs_err": errs, "tol": TOL_PROTOCOL,
          "pooled_auc": [resc["auc"][2], resp["auc"][2]],
          "pooled_acc": [resc["acc"][2], resp["acc"][2]], "launches_cuda": launches,
          "wall_s": [resc["wall_time_s"], resp["wall_time_s"]], "ok": ok})
    if not ok:
        raise AssertionError("pretrain protocol: card vs CPU mismatch")
    sync("cuda")
    zero_launches()
    res = cli.main(base + ["--set", "model=pathcnn", *sets])
    sync("cuda")
    pl = launch_counts()
    ok = bool(pl == zero_counts() and np.isfinite(res["auc"][2]))
    emit({"phase": "pathcnn_protocol", "pooled_auc": res["auc"][2], "launches": pl,
          "wall_s": res["wall_time_s"], "ok": ok})
    if not ok:
        raise AssertionError("pathcnn protocol failed")
    return launches, pl


def slice10_phases(cfg, ctx, batch):
    """This slice's GBM-fold phases; returns ({path: serving launches},
    {path: launches per train step})."""
    serve, per_step = {}, {}
    for name, (sv, st) in pathcnn_phase(cfg, ctx).items():
        serve[f"serve_{name}"], per_step[name] = sv, st
    for kind in ("autoencoder", "vae", "vq_vae"):
        per_step[f"pretrain_{kind}"] = pretrain_phase(kind, cfg, ctx, batch)
    per_step["pretrain_autoencoder_foreach"] = pretrain_phase(
        "autoencoder", cfg, ctx, batch, decoder="foreach", n_steps=3)
    for head, (sv, st) in vae_finetune_phase(cfg, ctx, batch).items():
        serve[f"serve_vae_finetune_{head}"] = sv
        per_step[f"vae_finetune_{head}"] = st
    return serve, per_step


def card_setup() -> str:
    """TF32 off for matmuls and cuDNN; the card's nvidia-smi name and power
    limit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def build_phase() -> None:
    """Every kernel built from the checkout's sources, in parallel."""
    t0 = time.perf_counter()
    times = build.build_all()
    regs = {
        k.name: [ln.strip() for ln in k.ptxas_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        for k in build.REGISTRY.values()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": times, "ptxas": regs})


def gbm_fold():
    """The GBM cohort fold at gbm.yaml's widths, bf16 trunk, B = 32:
    (cfg, model, graph, ctx, batch)."""
    return make_gbm_scale_setup(topology="cohort", windowed=True, batch=32,
                                compute_dtype="bfloat16", spmm_bf16=True, device="cuda")


def train_setup(cfg, ctx):
    """(training cfg, ctx with a PCA seed): gbm.yaml's optimizer (Adam, lr
    1e-4, no clip, no StepLR, no wd) and dropouts (feature_drop 0.25, head
    dropout 0.5), 3 epochs, init_with_pca."""
    rng = np.random.RandomState(3)
    pca_seed = (rng.randn(ctx.num_pca_rows, cfg.pca_dim) * 0.05).astype(np.float32)
    ctx = dataclasses.replace(ctx, pca_seed=torch.as_tensor(pca_seed, device="cuda"))
    return cfg.replace(epochs=3, init_with_pca=True), ctx


def small_files(root) -> str:
    """The small reference-format files (SMALL_COHORT) under root/small."""
    from multilevel_gnn_tpu_torch.data.synthetic import write_reference_format

    small = f"{root}/small"
    write_reference_format(small, cancer_type="gbm", **SMALL_COHORT)
    return small


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    smi = card_setup()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_tf32": False, "cudnn_tf32": False})

    build_phase()

    t0 = time.perf_counter()
    cfg, model, graph, ctx, batch = gbm_fold()
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
    profile_serve(model, ctx, batch)
    ops_phase(graph, gen)
    export_launches = export_phase(model, ctx, batch)

    # ---- the training path
    b1, b2 = kernel_bwd(graph, ctx, w, F, cfg.batch_size * cfg.final_channels, gen)
    tcfg, ctx = train_setup(cfg, ctx)
    f32_model = MultilevelGNN(
        tcfg.replace(compute_dtype=None, spmm_bf16=False),
        graph.n_nodes, ctx.num_pca_rows, device="cuda", seed=0,
    )
    train_grad_checks((("bf16", model), ("f32", f32_model)), ctx, batch,
                      torch.tensor([1.0, 1.5], device="cuda"))
    del f32_model
    tr = train_phase(tcfg, ctx, init_state)
    train_per_step, train_kernel_ms = profile_train(tr["model"], ctx, tr["batch"],
                                                    tr["cw"], tr["per_step"])
    # the composed path: K1 over csr (2 layers), csc (2) and the PCA gather
    profile_train(tr["model"], composed_ctx(ctx), tr["batch"], tr["cw"],
                  {k1.KERNEL.name: 5, k2.KERNEL.name: 0, k3.KERNEL.name: 0,
                   k4.name: 0}, phase="profile_train_composed")
    del tr
    torch.cuda.empty_cache()
    repairs_phase(model, ctx, train_kernel_ms)
    paths = {"serve_sage": launches, "export": export_launches,
             "explain": explain_phase(model, ctx, batch)}
    optim_phase()
    torch.cuda.empty_cache()

    # ---- the other convs on the same fold: the max aggregations (MRConv,
    # EdgeConv), then GAT (the Config's default conv), GCN and GIN
    per_step = {"sage": train_per_step}
    for conv in ("mr", "edge", "gat", "gcn", "gin"):
        paths[f"serve_{conv}"], per_step[conv] = conv_paths(
            conv, tcfg, ctx, batch, n_batches)
    gat = MultilevelGNN(tcfg.replace(gnn_name="gat", final_head=GBM_FINAL_HEAD),
                        graph.n_nodes, ctx.num_pca_rows, device="cuda", seed=0)
    paths["export_gat"] = export_phase(gat, ctx, batch, "export_gat",
                                       conv_launches("gat", graph.winplan)[0])
    del gat
    torch.cuda.empty_cache()
    rz = kernel_zoo(graph, cfg.batch_size, cfg.hidden_channels, cfg.final_channels,
                    GBM_FINAL_HEAD, gen)
    options_phase(tcfg, ctx, batch)
    torch.cuda.empty_cache()
    # ---- PathCNN, the AE / VAE / VQ-VAE pretraining models, vae_finetune
    serve10, step10 = slice10_phases(tcfg, ctx, batch)
    paths.update(serve10)
    per_step.update(step10)

    # ---- K4 (sorted segment-sum): no path of the package reaches it
    r4 = kernel_k4(graph, cfg.batch_size, cfg.node_embedding_dim, F, gen)
    del model, ctx, batch
    torch.cuda.empty_cache()

    # ---- the protocol from reference-format files
    with tempfile.TemporaryDirectory() as root:
        cohort = cohort_phase(root)
        paths["experiment"] = experiment_phase(root)
        profile_phase(root)
        ckpt_dir = ckpt_phase(root, cohort)
        paths["predict"] = predict_phase(root, cohort, ckpt_dir)
        paths["explain_cli"] = explain_cli_phase(root, ckpt_dir)
        # ---- DeeperGCN on the same files' gene-level fold graph
        dg = deepergcn_phases(root, cohort, gen)
        paths["serve_deepergcn"] = dg["serve"]
        paths["experiment_deepergcn"] = dg["experiment"]
        per_step["deepergcn"] = dg["per_step"]
        del cohort
        # ---- STRING PPI tables beside the GRN list: edge_type ppi and merge
        from multilevel_gnn_tpu_torch.data.loaders import read_kegg_csv
        from multilevel_gnn_tpu_torch.data.synthetic import write_string_ppi

        write_string_ppi(root, read_kegg_csv(f"{root}/kegg.csv"), seed=3, e_ppi=PPI_EDGES,
                         cancer_type="gbm")
        small = small_files(root)
        write_string_ppi(small, read_kegg_csv(f"{small}/kegg.csv"), seed=3, e_ppi=800,
                         cancer_type="gbm")
        for edge_type in ("ppi", "merge"):
            paths[edge_type] = graph_source_phase(edge_type, root, small)
            torch.cuda.empty_cache()
        paths["gat_protocol"] = gat_protocol_phase(small)
        paths["pretrain_protocol"], paths["pathcnn_protocol"] = pretrain_protocol_phase(small)
    warm_phase()

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
    # other forms: K1 over all edges (the composed forward) and the f32
    # forms; K2's f32 sides; K4b, f32, and segment_sum_by through perm
    forms = {
        k1.KERNEL.name: [r1[("all_edges", "bfloat16")], r1[("all_edges", "float32")],
                         r1[("residual", "float32")]]
        + [b1[(c, "float32")] for c in ("csc", "tres", "res_csc", "gather_rows_bwd",
                                        "src_gather", "dst_gather")],
        k2.KERNEL.name: [r2["float32"], b2["float32"]],
        k4.name: [r4[key] for key in (("K4b", "bfloat16"), ("K4a", "float32"),
                                      ("K4b", "float32"),
                                      ("segment_sum_by", "bfloat16"))]}
    # DeeperGCN's forms on the gene-level fold: K3 at F = B*H and 2*B*H, K1
    # as edge_segment_sum's forward and gather_src's backward at F = B*H
    forms[k3.KERNEL.name] = [r3[(F, "float32")], r3[(cfg.batch_size * cfg.final_channels,
                                                     "bfloat16")],
                             r3[(cfg.batch_size * cfg.final_channels, "float32")]] + list(
        dg["r3"].values())
    forms[k1.KERNEL.name] += list(dg["r1"].values())
    # the forms of gat, gcn and gin on the GBM fold (kernel_zoo)
    forms[k1.KERNEL.name] += [r for key, r in rz.items() if key[0].startswith(("gat", "gcn_res"))]
    forms[k2.KERNEL.name] += [r for key, r in rz.items() if key[0] in ("gcn_k2", "gcn_k2_t",
                                                                      "gin_k2")]
    # launches: the count on the kernel's first serving path (sage for K1
    # and K2, mr for K3); every path's count is in launches_by_path
    first = {k1.KERNEL.name: "serve_sage", k2.KERNEL.name: "serve_sage",
             k3.KERNEL.name: "serve_mr", k4.name: "serve_sage"}
    # the torch.library ops each kernel backs
    ops = {k1.KERNEL.name: ["mgtpu::segment_spmm_csr", "mgtpu::segment_spmm_csr_acc"],
           k2.KERNEL.name: ["mgtpu::windowed_tile_spmm"],
           k3.KERNEL.name: ["mgtpu::segment_max_csr"],
           k4.name: ["mgtpu::sorted_segment_sum"]}
    kernels = []
    for k, r in ((k1.KERNEL, main_k1), (k2.KERNEL, main_k2), (k3.KERNEL, main_k3),
                 (k4, main_k4)):
        kernels.append({
            "name": k.name, "route": k.route, "source": k.source_rel, "ops": ops[k.name],
            "replaces": k.replaces, "launches": paths[first[k.name]][k.name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "ms_source": r["ms_source"],
            "event_ms": r["event_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "train_launches_per_step": per_step[
                "sage" if first[k.name] == "serve_sage" else "mr"][k.name],
            "launches_by_path": {p: c[k.name] for p, c in paths.items()},
            "train_launches_per_step_by_path": {
                p: c[k.name] for p, c in per_step.items()},
            "backward": [
                {key: b[key] for key in ("case", "max_abs_err", "ms", "ms_source", "event_ms",
                                         "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for b in backward[k.name]
            ],
            "forms": [
                {key: b.get(key) for key in ("case", "dtype", "shape", "F", "max_abs_err",
                                             "ms", "ms_source", "event_ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}
                for b in forms.get(k.name, [])
            ],
        })
    emit({"phase": "profiler_windows", **WINDOWS})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
