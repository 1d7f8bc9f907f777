#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
hold every kernel, forward and backward, against its plain PyTorch version.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU and nvcc (CUDA_HOME, PATH or /usr/local/cuda).
Exits non-zero, printing no result, without a card.  Phases, one JSON line
each:

  device   card name, count, nvidia-smi name/power limit, precision flags
  build    nvcc of every kernel source, in parallel, and g++ of the data
           libraries beside them (seconds)
  setup    GBM-scale fold: N = 15,405 node slots, E ~ 154k edges incl. self
           loops, cohort topology with the windowed plan, B = 32, bf16 trunk
  k1 / k2  each kernel at the main path's shapes, bf16 and f32, against its
           plain version (max abs error, stated tolerance; device ms per
           call of the kernel, the plain version and the torch.sparse.mm
           library call, from the profiler, and the kernel's CUDA-event ms
           around one call, which adds the host's launch time):
           K1 over all edges (the composed forward) and over the windowed
           residual, with the rows it visits (warp items, long-row
           blocks, split rows and their chunks; every K1 line of the
           script carries these counts and fails unless two calls from
           the same inputs are equal bit for bit); K2's forward side, with
           its block and entry counts
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
  pathway  PW, the pathway contraction's forward and backward kernels, at
           kirc's (G 25,015, S 438, K 3, F 2,048) and gbm's (K 2, F 1,024)
           shapes, bf16 and f32: against the plain versions (the forward
           and dP within 1e-4 x max(1, max|plain|), dx equal, two calls
           equal bit for bit) and the dense form's dx (equal); ms beside
           the byte bound, the plain version's and the dense cuBLAS form's
  dma_gather  P1, tools/bench_dma_gather.py's row-gather probe, at the
           tool's shapes (x3 (15,408, 16, 128), 165,888 gathered rows,
           chunks of 256; inputs from RandomState(0) as the tool makes
           them), f32 then bf16: its path, one call per dtype, counted (P1
           1, no other kernel); the kernel against its plain version
           (1e-4 x max(1, max|ref|)) and a second call (equal bit for bit);
           ms, event ms, plain ms, bound, the time of every gathered row
           read from HBM, rows/s, gathered GB/s, embedding_bag's sum of the
           same rows (ms; its first 128 columns within 1e-4 / 2e-3) and
           K1's csr ms at F 2,048 beside it; every output also equal bit
           for bit to dma_row_gather_ordered (the kernel's order of
           additions).  Then one line a reading: "tool, cold" (the L2
           flushed before each call), "l2_resident" (src drawn from the
           rows of x3 that fill half the L2: the card's rate of whole rows
           copied from L2 into shared memory) and "k1_stream" (src = the
           fold's csr source rows, x3 an (N, 2,048) input viewed as (N, 16,
           128)), with K1's csr ms of the same dtype beside it

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
  train_<conv>  run_fold for 1 epoch (gbm.yaml's optimizer and dropouts),
           launches counted over it; ms per step
  profile_train_<conv>  as profile_train, on one batch: launches per step
           from the counters

and then, on the same fold:

  export_gat  the export phase for a GAT fold (K1 4 a call, K2 0); its
           artifact loaded after export's in the same process
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
           written in the reference's file layout (by a child process
           started after build, beside the card's phases), loaded with
           gbm.yaml and
           fold 0 derived; seconds by stage, the MI estimator's seconds at
           k = 7 and 15, node slots, edges, mask share, whether the
           windowed plan engaged
  experiment  the train CLI's main on those files, 1 run x 5 folds x 1
           epoch at gbm.yaml's widths, bf16, launch counts zeroed just
           before and read just after (K1 > 0; K2 as the folds' plans say);
           per-fold derivation s, ms per step, host s per epoch, pooled AUC
           and ACC; then a small protocol (f32, dropout off, 2 epochs) on
           the card and on the CPU, fold test scores within 1e-4

Between k4 and cohort, on the same fold, the shipped configs of the other
two cohorts, kirc.yaml and lgg.yaml (B = 64, pca_dim 3, head_dim 512, the
pathway reorder; kirc pools 1 x 1 without age, lgg pools 4 x 2 with it; the
first SAGE layer's SpMMs at F = B*32 = 2,048, the second's at B*64 = 4,096),
each config's model built by Config.from_yaml with only node_num and
pathway_num set to the fold's, bf16 trunk with spmm_bf16, a seeded
non-identity reorder of the 146 pathways in the fold's context:

  shipped_k2 / shipped_k1  K2 forward and transpose, K1 over the residual,
           tres and res_csc (accumulating) and over csr and csc at F =
           4,096, and K1 as the gather_rows backward at F = 2,048, bf16 and
           f32, against their plain versions and equal over two calls bit
           for bit, with ms, bound, plain and library ms
  serve_<name>  predict_patients over the 123 patients (two batches of
           64), counted: K1 2 / K2 2 a batch
  slice_<name> / per_call_eval_<name>  the forward with kernels against
           plain versions (bf16 and f32 trunks), and every K1 / K2 call of
           the bf16 forward against its plain version on its own inputs
  profile_<name>  device ms by kernel of one full eval batch, gap share
  train_grad_<name> / per_call_step_<name> / train_grad_repeat_<name>  one
           step's gradients, kernels against plain versions (TOL_GRAD), the
           same parameters without a gradient on both sides; every kernel
           call of the step against its plain version; three calls'
           gradients equal bit for bit
  profile_train_<name>  launches per step from the counters (K1 7 / K2 4),
           kernel ms, gap share, peak memory

and after experiment, on the same files (root/<name> linked to root/gbm):

  experiment_<name>  the train CLI under configs/<name>.yaml, 1 run x 5
           folds x 1 epoch, counted as experiment is; each fold's pathway
           reorder traced (kirc: derived in each fold under
           selected_similarity; lgg: the cohort's initial one)
  experiment_<name>_small_vs_cpu  the small protocol under that config
           (f32, dropout off, 2 epochs) on the card and on the CPU, fold
           test scores within 1e-4

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

  ckpt     run_experiment (gbm.yaml, bf16, 1 run x 5 folds x 3 epochs,
           ckpt_every 1) uninterrupted, then interrupted in fold 1 by the
           interrupt_after hook and resumed: pooled AUC / ACC and every
           fold's test scores must be equal; a step's bytes, load and save
           ms
  predict  the predict CLI on fold 2's checkpoint equals predict_fold with
           the same parameters in memory; ms and launches per batch of 32
  explain_cli  the explain CLI once on fold 0's checkpoint

Then fold-parallel CV (train/fold_parallel.py), U = 5 units in one stacked
step: five GBM-scale folds (make_gbm_scale_setup's cohort topology at
seeds 0-4, windowed, bf16, B = 32) and the same files:

  fold_parallel_plans / _k1 / _k2 / _k3  the block-diagonal plans of the
           five folds; K1 (residual, accumulating; all edges), K2 (forward
           and transpose sides) and K3 over them at F = 2,048, bf16 and
           f32: against their plain versions (TOL_BF16 / TOL_F32; K3
           equal) and against the five folds' own launches (bit-equal),
           with ms, the five launches' ms (per_unit_ms), bound, plain and
           torch.sparse.mm / scatter_reduce_(amax) ms
  fold_parallel_step  one stacked sage bf16 train step: each unit's
           gradients against its own step's (same dropout masks) within
           TOL_GRAD; K1 7 / K2 4 a stacked step; CUDA-event ms, kernel ms,
           gap share and peak memory against the five units' own steps
  fold_parallel_serve  one stacked eval batch: probabilities against the
           units' own eval_steps within TOL_FP_PROB (bf16 and f32 trunks),
           K1 2 / K2 2, ms, gap and peak memory against five eval_steps
  fold_parallel_protocol  the train CLI with --fold-parallel on the files
           (1 run x 5 folds x 1 epoch, counted), then the sequential CLI:
           wall s, derivation and stacking s, host s per epoch, the stacked
           step's ms; fold_parallel_protocol_small: a small protocol (f32,
           dropout off, 2 epochs) fold-parallel on the card and on the CPU
           and sequential on the card, pooled AUC / ACC within TOL_PROTOCOL
  fold_parallel_ckpt  fold-parallel with ckpt_every 1 (3 epochs)
           uninterrupted and stopped after 2 then resumed: pooled AUC /
           ACC equal; the predict CLI scores fold 2 from its checkpoint,
           equal to predict_fold with it loaded in memory

and, after fold_parallel_serve, on the same five GBM folds (as units of
vae_finetune and PathCNN), and after fold_parallel_ckpt on the files'
DeeperGCN folds (the other families' stacked steps):

  fold_parallel_vae_finetune_step / _serve  vae_finetune (sage bf16 trunk,
           DiffPool head over each unit's own P x P adjacency) stacked:
           gradients against the units' own steps within TOL_GRAD, K1 7 /
           K2 4 a step; probabilities within TOL_FP_PROB, K1 2 / K2 2 a
           batch (the ConvHead's serving too, _conv_head_serve); ms, gap
           and peak against the units' own
  fold_parallel_pathcnn_step  PathCNN (learnable PCA, f32) stacked: its
           convolutions grouped, no port kernel; gradients within TOL_F32
  fold_parallel_deepergcn_plans / _k3 / _k1  the five DeeperGCN folds'
           gene graph stacked (U * E * F past 2^31 elements at F = 4,096):
           K3 (bf16, f32; equal), K1 as edge_segment_sum and gather_src's
           backward (bf16, f32) and as the edge-id lookup's backward (f32,
           H 128; index_add_ beside it), each against its plain version
           and bit-equal to the folds' own launches, with ms, the own
           launches' ms, bound, plain and library ms
  fold_parallel_deepergcn_units  one unit's train step peak; U = 5 if five
           fit the card with 10% to spare, else the most that do
  fold_parallel_deepergcn_step / _serve  DeeperGCN (bf16, B = 32, H 128, 3
           layers, max) stacked at U: gradients within TOL_GRAD, K3 3 / K1
           4 a step; probabilities within TOL_FP_PROB, K3 3 a batch; ms,
           gap and peak against the units' own
  fold_parallel_families_protocol_small  the train CLI's --fold-parallel on
           the small files (f32, dropout off, 2 epochs) for deepergcn (max,
           softmax), pathcnn (learnable PCA, pathway image) and
           vae_finetune (ConvHead, DiffPool) on the card and on the CPU:
           pooled AUC / ACC within TOL_PROTOCOL, launches counted
  fold_parallel_deepergcn_ckpt  DeeperGCN fold-parallel on the small files
           with ckpt_every 1, stopped after 2 of 3 epochs and resumed:
           equal; the predict CLI's fold 2 equal to predict_fold in memory

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
  experiment_deepergcn  the train CLI's main, 1 run x 5 folds x 1 epoch,
           bf16, counted, peak memory; then a small protocol (f32, dropout
           off, 2 epochs) card against CPU, gcn_aggr softmax and max,
           fold test scores within 1e-4

On the same DeeperGCN fold, after profile_train_deepergcn:

  explain_deepergcn  integrated_gradients of DeeperGCN (16 steps, B = 32,
           bf16, max): K3 3 / K1 3 launches a step, as the code predicts;
           device ms, peak memory, kernels against plain versions (TOL_IG);
           pathway_attributions raising IndexError, as the JAX package's
  multiomix_fold  Cohort.multiomix_vnode_data on the fold: per omics its
           gene -> pathway-vnode edges and the pathway rows they reach
  k3_vnode / k1_vnode  K3 over a vnode graph's csr, K1 as its
           edge_segment_sum and its gather_src backward, F = B*128, f32,
           against plain versions, with ms, bound and library ms
  serve_multiomix_{max,softmax}  MultiOmixGCN (gbm.yaml, model=multiomix,
           H = 128, 3 layers, res+, maxpool, f32) over the 123 serving
           patients: launches a batch as mo_launches predicts (max K3 15;
           softmax K1 30), kernels against plain versions (max: the whole
           forward equal; both: every kernel call on its own inputs,
           PerCall), ms a batch, device ms of one
  train_grad_multiomix_{max,softmax}  one class-weighted BCE step at the
           largest B that fits: launches (max K3 15 / K1 15; softmax K1
           45), peak memory, step ms, gradients against plain versions
           (max: TOL_F32; both: PerCall)
  dyn_DynConv / dyn_ResDynBlock  N = 15,405, C = 64, k = 9, conv edge: the
           kNN graph and its plans built on the card with synchronising
           calls set to raise; forward and backward (K3 1 / K1 2) against
           plain versions; k3_knn / k1_knn: the kNN plan's kernel forms
  minet    OmicsNet (15,405 inputs, 5,135 genes, 146 pathways, B = 32): eval
           and a training step with dropout masks, card against CPU
  dense_*  ResDynBlock2d and DenseDynBlock2d on a (2, 64, 2048, 1) cloud,
           card against CPU

Then the custom ops, export, the profiler trace, the PPI / merge graph
sources and warm, each failing the run when its check fails:

  ops      torch.library.opcheck (schema, fake function, dispatch, aot
           dispatch) of every mgtpu custom op on CUDA tensors over the GBM
           fold's plans (F = 64), right after profile_serve
  export   the GBM sage fold's eval forward (bf16, windowed, B = 32)
           exported with torch.export and saved; after export_gat both
           artifacts are loaded in one fresh process: probabilities against the live eval_step on the same
           batch within 1e-6 x max(1, max|ref|), K1 2 / K2 2 launches per
           call as in the live call; the artifact's bytes, load and
           first-call seconds, CUDA-event and device ms of an exported call
           against a live one, the mgtpu ops in the graph and whether
           functionalization added copies (auto_functionalized nodes)
  profile_cli  (after experiment) the train CLI with --profile-dir on the small
           protocol files, 1 run x 5 folds x 1 epoch: the trace's bytes,
           K1's kernel symbol in it; wall time against the same protocol
           without it, run before it
  ppi / merge  (after explain_cli) STRING-layout PPI tables (45,000 pair
           rows over the cohort's genes) beside the files: the train CLI at
           gbm.yaml widths with edge_type ppi, then merge, 1 run x 5 folds x
           1 epoch, counted; edges per fold and their path, derivation s;
           profile_train_<edge_type> on fold 0 (launches per step as the
           plans predict, merge running the stack over both graphs); a
           small protocol (f32, dropout off, 2 epochs) card against CPU
           within 1e-4
  gat_protocol_vs_cpu  (after merge) the train CLI on small
           reference-format files with gnn_name gat (f32, dropout off, 1 run
           x 5 folds x 2 epochs) on the card and on the CPU: fold test scores
           within 1e-4, pooled AUC / ACC equal
  warm     the warm CLI in a copy of the package with nothing built (its
           builds' seconds), then the train CLI's --bench-scaling from
           that copy: every kernel and data library found built (0.0 s)
  bench_scaling  that run's line: JAX's keys, the anchor only on one card
           (the mean aggregation on the windowed GBM graph, forward and
           backward, B = 2, C = 64, K2 + K1, CUDA events)

Then the ('data', 'model') mesh (parallel/).  NCCL refuses two ranks on
one card, so NCCL runs at world size 1 and two gloo ranks share cuda:0,
each collective of card tensors staged through host memory; the kernels
run on the card in both:

  mesh_ws1  a spawned rank of an NCCL group of world size 1: NCCL's
           all_reduce (sum, max), all_to_all_single and all_gather on card
           tensors; the edge-shard sum, mean (K1) and max (K3) and the
           halo form at k = 1 (K2 + K1) of the GBM fold (f32, B*C =
           2,048) against single-device gather_scatter (TOL_F32; max
           equal), launches counted
  mesh_halo  two gloo ranks, 1 x 2: the halo mean of the GBM fold (bf16,
           windowed interiors) forward and backward against the single
           device's bf16 sum over the degree (TOL_BF16; the input gradient
           within one bf16 ulp, TOL_BF16_ULP) and, in f32, the single
           device's mean (TOL_F32); every K1 / K2 call against its plain
           version (MeshPerCall); launches as _halo_predicted says; H,
           interior / boundary edges, the all_to_all's and the
           all-gather's bytes against the psum's; CUDA-event ms of a
           forward and backward and each rank's kernels' device ms
  mesh_step  the GBM sage model (gbm.yaml's dropouts), one train step on
           1 x 2 with the halo and one on 2 x 1, bf16 and f32 trunks: the
           loss (1e-4) and each parameter's gradient against the single
           device step's (TOL_MESH_GRAD), 2 x 1 against the single device
           step on its own SpMM (TOL_GRAD), the witnesses of the bf16 gap,
           launches, ms a step a rank
  mesh_protocol  the small protocol (f32, dropout off, 2 epochs) on 2 x 1
           and on 1 x 2 with the halo: every fold's test scores against
           the experiment phase's runs on the card and on the CPU
           (TOL_PROTOCOL), pooled AUC equal on both ranks, launches
  mesh_forms  rank 0's plans of the GBM fold on two ranks, timed in this
           process alone on the card, against their plain versions, with
           ms, bound, plain and library ms: the halo's interior K2
           (forward, transpose), boundary K1 (by receiver; by halo slot),
           the send gather's backward K1, the edge shard's K1 (csr) and K3

Kernel cases off the main path (other feature widths, permuted plans,
empty plans) are in tests/test_torch_cuda_kernels.py.

Then the card's nvidia-smi line, the kernels line (per kernel: its serving
numbers, its launches on each path and per train step, its backward forms'
and other forms' numbers) and the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
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
from multilevel_gnn_tpu_torch.ops.kernels import dma_gather as p1
from multilevel_gnn_tpu_torch.ops.kernels import pathway as pw
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
    "dma_row_gather": ("gather_chunks_kernel", "add_partials_kernel"),
    "pathway_contract_fwd": ("pathway_fwd_kernel", "pathway_add_parts_kernel"),
    "pathway_contract_bwd": ("pathway_bwd_kernel",),
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
CONV_EPOCHS = 1
GBM_FINAL_HEAD = 4  # gbm.yaml's final_head: GAT's last layer's heads


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries t_s, the seconds since the
    script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 2)}
    print(json.dumps(obj), flush=True)


WINDOWS = {"kept": 0, "dropped": 0}  # device_ms's profiled windows, over the run


def device_ms(fn, iters: int = 10, windows: int = 3, warmup: int = 3,
              symbols=None) -> float:
    """Device time of one fn() call in ms: the time of the kernels it
    launches (only those whose names hold one of ``symbols``, where
    given), from the profiler's device rows, per call over iters calls;
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
        rows = [r for r in kernel_rows(prof, iters)
                if symbols is None or any(k in r[0] for k in symbols)]
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


def k1_classes(plan, acc):
    """The rows and chunks K1 visits on a plan, by class (a device-built
    plan's -1 padding left out)."""
    def real(t):
        return int((t >= 0).sum())

    items = plan.items[:plan.n_busy] if acc else plan.items
    return dict(warp_rows=real(items), long_rows=real(plan.long_rows),
                split_rows=real(plan.split_rows), chunks=real(plan.chunk_row))


def time_k1(name, plan, x, w, acc, gen, library=None, reps=10):
    """K1 on one plan against its plain version (accumulating into a random
    base when acc), and against itself (a second call from the same inputs
    must be equal bit for bit), with its ms, plain ms, bound and library ms
    (the plain version and the library call timed over ``reps`` calls a
    window)."""
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
    again = k1.segment_spmm_csr(x, w, plan, base.clone() if acc else None)
    ref = k1.segment_spmm_csr_plain(x, w, plan, base.clone() if acc else None)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"k1 {name} {dt}: two calls differ by "
                             f"{float((out - again).abs().max())}")
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
        **k1_classes(plan, acc), bitwise_repeat=True, max_abs_err=e, ref_max=m,
        limit=limit, ms=ms, ms_source=src,
        event_ms=cuda_ms(kern), plain_ms=device_ms(plain, iters=reps),
        library_ms=device_ms(library, iters=reps) if library is not None else None,
        bound_ms=bms, bound_by=by, bytes=b, flops=fl,
    )


def time_k2(name, plan, x, w, transpose):
    dt = x.dtype
    side = plan.bwd if transpose else plan.fwd

    def kern():
        return k2.windowed_tile_spmm(x, w, plan, transpose)

    def plain():
        return k2.windowed_tile_spmm_plain(x, w, plan, transpose)

    out, again, ref = kern(), kern(), plain()
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"k2 {name} {dt}: two calls differ by "
                             f"{float((out - again).abs().max())}")
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
    slices, vector = k2.launch_shape(x, out)
    return dict(
        case=name, dtype=str(dt).split(".")[-1], F=x.shape[1],
        blocks=side.n_blocks, entries=side.n_entries,
        feature_slices=slices, vector=vector,
        bitwise_repeat=True, max_abs_err=e,
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


def time_k3(graph, msg, reps=10):
    """K3 over the graph's csr against its plain version (equal), with its
    ms, plain ms, bound and the scatter_reduce amax library call on the
    same rows (those two timed over ``reps`` calls a window)."""
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
        lib_ms = device_ms(library, iters=reps)
    except (RuntimeError, NotImplementedError):
        lib_ms = None
    del rows, idx, dst
    ms, src = kernel_ms(lambda: k3.segment_max_csr(msg, plan), bms)
    return dict(
        case=f"csr F={F}", dtype=str(dt).split(".")[-1], nnz=plan.nnz, F=F,
        max_abs_err=e, ref_max=m, limit=0.0, ms=ms, ms_source=src,
        event_ms=cuda_ms(lambda: k3.segment_max_csr(msg, plan)),
        plain_ms=device_ms(lambda: k3.segment_max_csr_plain(msg, plan), iters=reps),
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


# P1, tools/bench_dma_gather.py's probe at the tool's shapes: N rows of
# (16, 128), E gathered rows, chunks of te edges; the kernel and its plain
# version are held at TOL_F32 in both dtypes (the inputs are exact in f32),
# to dma_row_gather_ordered (its own order of additions) bit for bit, and
# embedding_bag's sum (its output in x3's dtype) at TOL_F32 / TOL_BF16
P1_N, P1_E, P1_TE = 15_408, 165_888, 256
TOL_P1_LIBRARY = {"float32": TOL_F32, "bfloat16": TOL_BF16}


def p1_inputs():
    """{dtype name: (x3, src)} on the card, made as the tool makes them: one
    RandomState(0), x3 then src for f32, then for bf16; src's range checked
    here, once."""
    rng = np.random.RandomState(0)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x3 = torch.from_numpy(rng.randn(P1_N, 16, 128)).to(dt).to("cuda")
        src = torch.from_numpy(rng.randint(0, P1_N, P1_E).astype(np.int32)).to("cuda")
        p1.check_src(src, P1_N)
        out[str(dt).split(".")[-1]] = (x3, src)
    return out


def p1_checks(name, x3, src, out, ordered):
    """P1's output ``out`` against its plain version (TOL_F32), a second
    call (equal bit for bit, the 8 rows equal) and, where ``ordered`` is
    given, dma_row_gather_ordered (equal bit for bit).  Returns (max abs
    error, max |plain|, limit, the f32 words' sha256 prefix)."""
    import hashlib

    again = p1.dma_row_gather(x3, src, P1_TE)
    ref = p1.dma_row_gather_plain(x3, src)
    torch.cuda.synchronize()
    e, m = err_of(out, ref)
    limit = check(name, e, m, TOL_F32)
    words = out.view(torch.int32)
    if not (torch.equal(words, again.view(torch.int32)) and bool((out == out[:1]).all())):
        raise AssertionError(f"{name}: two calls differ, or the 8 rows do")
    if ordered is not None and not torch.equal(
            words, ordered(x3, src, P1_TE).view(torch.int32)):
        raise AssertionError(f"{name}: not equal bit for bit to dma_row_gather_ordered")
    sha = hashlib.sha256(words.cpu().numpy().tobytes()).hexdigest()[:16]
    return e, m, limit, sha


def p1_bound(x3, src):
    """(bound ms, bound_by, bytes) of one P1 call: each row of x3 that src
    names read once, src read once, the (8, 128) f32 output written once;
    E x 128 f32 adds."""
    row_bytes = x3[0].numel() * x3.element_size()
    b = int(torch.unique(src).numel()) * row_bytes + src.shape[0] * 4 + p1.OUT_ROWS * 128 * 4
    return (*bound(b, float(src.shape[0]) * 128, "f32"), b)


def p1_cold(x3, src):
    """P1 with the L2 flushed before each call (a buffer of twice the L2
    written between calls): (device ms of P1's kernels from the profiler,
    CUDA events around the call alone, median of 20)."""
    l2 = torch.cuda.get_device_properties(x3.device).L2_cache_size
    flush = torch.empty(2 * l2, dtype=torch.uint8, device=x3.device)

    def fn():
        flush.fill_(1)
        p1.dma_row_gather(x3, src, P1_TE)

    ms = device_ms(fn, symbols=SYMBOLS[p1.KERNEL.name])
    times = []
    for _ in range(20):
        flush.fill_(1)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        p1.dma_row_gather(x3, src, P1_TE)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return ms, float(np.median(times))


def p1_reading(reading, x3, src, ordered, out=None, **extra):
    """One P1 reading at te = P1_TE: the checks of p1_checks on ``out``
    (a new call's output unless given), the warm ms (kernel_ms) and event
    ms, bound and gathered TB/s."""
    dt = str(x3.dtype).split(".")[-1]
    if out is None:
        out = p1.dma_row_gather(x3, src, P1_TE)
    e, m, limit, sha = p1_checks(f"dma_gather {reading} {dt}", x3, src, out, ordered)
    bms, by, b = p1_bound(x3, src)
    ms, ms_src = kernel_ms(lambda: p1.dma_row_gather(x3, src, P1_TE), bms)
    gathered = src.shape[0] * x3[0].numel() * x3.element_size()
    return dict(reading=reading, dtype=dt, shape=list(x3.shape), E=src.shape[0], te=P1_TE,
                rows_read=int(torch.unique(src).numel()), max_abs_err=e, ref_max=m,
                limit=limit, bitwise_repeat=True,
                ordered_equal=True if ordered is not None else None, out_sha=sha, ms=ms,
                ms_source=ms_src,
                event_ms=cuda_ms(lambda: p1.dma_row_gather(x3, src, P1_TE)),
                bound_ms=bms, bound_by=by, bytes=b,
                gathered_tb_per_s=gathered / (ms / 1e3) / 1e12, **extra)


def p1_readings(x3, src, ordered, graph, k1_csr_ms):
    """The readings P1 is read by, beside the tool's warm one: cold (the L2
    flushed before each call), L2-resident (the same E, src drawn from the
    first rows of x3 that fill half the L2: the card's rate of whole rows
    copied from L2 into shared memory) and K1's stream on the fold's graph
    (src = the csr's source rows, x3 = an (N, 2,048) input of the fold
    viewed as (N, 16, 128)), beside K1's csr ms at F 2,048 ({dtype name:
    ms}).  One phase line each; returns {reading: line}."""
    dt = str(x3.dtype).split(".")[-1]
    E, row_bytes = src.shape[0], x3[0].numel() * x3.element_size()
    res = {}
    cold_ms, cold_event_ms = p1_cold(x3, src)
    bms, by, _ = p1_bound(x3, src)
    res["tool, cold"] = dict(reading="tool, cold", dtype=dt, E=E, te=P1_TE, ms=cold_ms,
                             ms_source="profiler, P1's kernels", event_ms=cold_event_ms,
                             bound_ms=bms, bound_by=by,
                             hbm_every_row_ms=E * row_bytes / HBM_BYTES_PER_S * 1e3,
                             gathered_tb_per_s=E * row_bytes / (cold_ms / 1e3) / 1e12)
    l2 = torch.cuda.get_device_properties(x3.device).L2_cache_size
    n_l2 = l2 // 2 // row_bytes
    rng = np.random.RandomState(1)
    src_l2 = torch.from_numpy(rng.randint(0, n_l2, E).astype(np.int32)).to(x3.device)
    res["l2_resident"] = p1_reading("l2_resident", x3, src_l2, ordered, l2_rows=n_l2,
                                    l2_bytes=l2)
    N = graph.n_nodes
    gen = torch.Generator(device=x3.device).manual_seed(5)
    x = torch.randn(N, 16 * 128, generator=gen, device=x3.device).to(x3.dtype)
    p1.check_src(graph.csr.col, N)
    res["k1_stream"] = p1_reading("k1_stream", x.view(N, 16, 128), graph.csr.col, ordered,
                                  k1_csr_ms_f2048=k1_csr_ms[dt])
    for reading, r in res.items():
        r["case"] = f"row gather te={P1_TE}, {reading}"
        emit({"phase": "dma_gather", **r, "ok": True})
    return res


def time_p1(x3, src, out, ordered):
    """P1's reading at the tool's shapes, warm (p1_reading on the path's
    output ``out``), with the plain version's ms, the time of every
    gathered row read from HBM, and embedding_bag's sum of the same rows
    (checked on the first 128 columns) and ms (over 3 calls a window: one
    bag of E rows takes tens of ms)."""
    import torch.nn.functional as F

    dt = str(x3.dtype).split(".")[-1]
    N, E = x3.shape[0], src.shape[0]
    row_bytes = x3[0].numel() * x3.element_size()
    r = p1_reading("tool, warm", x3, src, ordered, out)
    ref = p1.dma_row_gather_plain(x3, src)
    table, bag = x3.view(N, -1), src.long()[None]

    def library():
        return F.embedding_bag(bag, table, mode="sum")

    lib_err, _ = err_of(library()[0, :ref.shape[1]].float(), ref[0])
    lib_limit = check(f"dma_gather embedding_bag {dt}", lib_err, r["ref_max"],
                      TOL_P1_LIBRARY[dt])
    gathered, ms = E * row_bytes, r["ms"]
    return dict(
        case=f"row gather te={P1_TE}", **r, chunks=-(-E // P1_TE), row_bytes=row_bytes,
        plain_ms=device_ms(lambda: p1.dma_row_gather_plain(x3, src)),
        library_ms=device_ms(library, iters=3), library_max_abs_err=lib_err,
        library_limit=lib_limit, hbm_every_row_ms=gathered / HBM_BYTES_PER_S * 1e3,
        rows_per_s=E / (ms / 1e3), gathered_gb_per_s=gathered / (ms / 1e3) / 1e9,
    )


def dma_gather_phase(k1_csr_ms, build_s, graph, ordered):
    """P1's path, the row-gather probe at the tool's shapes, f32 then bf16:
    per dtype one call of the kernel, counted (launch counts zeroed just
    before, read just after: P1 once, no other kernel), then time_p1 on
    its output and p1_readings (cold, L2-resident and K1's stream on the
    fold's graph).  One line per dtype and reading, with the
    kernel's build seconds and K1's csr ms at F 2,048 ({dtype name: ms},
    the composed SpMM's, whose gather the probe floors) beside it.
    ``ordered`` is dma_row_gather_ordered, the kernel's order of additions
    (None, for a probe of a tree without it: no bit-for-bit check against
    it).  Returns ({kernel: launches over the path}, {dtype name:
    time_p1's row}, [p1_readings' lines])."""
    path, rows, readings = Counter(), {}, []
    for dt, (x3, src) in p1_inputs().items():
        torch.cuda.synchronize()
        zero_launches()
        out = p1.dma_row_gather(x3, src, P1_TE)
        torch.cuda.synchronize()
        launches = launch_counts()
        expect_launches(f"dma_gather {dt}", launches, want_launches({p1.KERNEL.name: 1}))
        path.update(launches)
        if not (out.shape == (p1.OUT_ROWS, 128) and bool(torch.isfinite(out).all())):
            raise AssertionError(f"dma_gather {dt}: output {tuple(out.shape)} not finite")
        rows[dt] = time_p1(x3, src, out, ordered)
        emit({"phase": "dma_gather", **rows[dt], "launches": launches,
              "build_s": build_s, "k1_csr_ms_f2048": k1_csr_ms[dt], "ok": True})
        readings += p1_readings(x3, src, ordered, graph, k1_csr_ms).values()
        del x3, src
    return {k: path[k] for k in build.REGISTRY}, rows, readings


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


# kirc's and gbm's pathway contraction: G PCA rows in 3 x 146 slots, the
# benchmark's synthetic fold's slot ids (sorted, 35-81 rows a slot)
PW_SHAPES = (("kirc", 3, 64 * 32), ("gbm", 2, 32 * 32))
PW_G, PW_S = 25_015, 438


def pathway_phase():
    """PW, the pathway contraction's kernels, at kirc's (K 3, F 2,048) and
    gbm's (K 2, F 1,024) shapes, bf16 and f32: each against its plain
    version (the forward and dP within TOL_F32 x max(1, max|plain|), dx
    equal, two calls equal bit for bit), one launch a call, and its time
    beside its byte bound (x and P read and the output written once; the
    backward's cotangent read once), the plain version's time and that of
    the dense cuBLAS form the port ran before ("library": the slot one-hot,
    its copy weighted by P, x in f32 and the (K*S, G) @ (G, F) product;
    backward: the K products for dx, the f32 product for dW and its
    reduction through the one-hot)."""
    ids = np.sort(np.random.RandomState(0).randint(0, PW_S, PW_G))
    plan = pw.SlotPlan.build(ids, PW_S).to("cuda")
    seg = torch.as_tensor(ids, device="cuda")
    out = {}
    for name, K, F in PW_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(K * F)
            x = torch.randn(PW_G, F, generator=g, device="cuda").to(dtype)
            p = torch.randn(PW_G, K, generator=g, device="cuda")
            gout = torch.randn(K * PW_S, F, generator=g, device="cuda")
            ds = x.element_size()
            fwd_bytes = PW_G * F * ds + PW_G * K * 4 + K * PW_S * F * 4
            bwd_bytes = 2 * PW_G * F * ds + 2 * PW_G * K * 4 + K * PW_S * F * 4
            f0, b0 = pw.FWD_KERNEL.launches, pw.BWD_KERNEL.launches
            o1, o2 = pw.pathway_fwd(x, p, plan), pw.pathway_fwd(x, p, plan)
            (dx1, dp1), (dx2, dp2) = (pw.pathway_bwd(x, p, gout, plan) for _ in range(2))
            torch.cuda.synchronize()
            launches = (pw.FWD_KERNEL.launches - f0, pw.BWD_KERNEL.launches - b0)
            ro = pw.pathway_fwd_plain(x, p, plan)
            rdx, rdp = pw.pathway_bwd_plain(x, p, gout, plan)
            errs = {"out": err_of(o1, ro), "dp": err_of(dp1, rdp)}
            ok = (launches == (2, 2) and torch.equal(dx1, rdx)
                  and all(e <= TOL_F32 * max(1.0, m) for e, m in errs.values())
                  and torch.equal(o1, o2) and torch.equal(dx1, dx2) and torch.equal(dp1, dp2))
            M = (seg[None, :] == torch.arange(PW_S, device="cuda")[:, None]).float()

            def lib_fwd():
                W = M[None] * p.T[:, None, :]
                return W.reshape(K * PW_S, PW_G) @ x.float()

            W = M[None] * p.T[:, None, :]

            def lib_bwd():
                gk = gout.reshape(K, PW_S, -1)
                dx = None
                for k in reversed(range(K)):
                    d = (W[k].T @ gk[k]).to(dtype)
                    dx = d if dx is None else dx + d
                dW = (gout @ x.float().T).reshape(K, PW_S, PW_G)
                return dx, (dW * M[None]).sum(1)

            lf, lb = lib_fwd(), lib_bwd()
            # the dense form's dx, bit for bit; its out and dP, f32 sum order
            dense = {"dx_equal": torch.equal(lb[0], dx1), "out_err": err_of(lf, o1)[0],
                     "dp_err": err_of(lb[1].T, dp1)[0]}
            ok = ok and dense["dx_equal"]
            del lf, lb
            row = {"shape": name, "dtype": str(dtype).split(".")[-1], "K": K, "F": F}
            for side, fn, nbytes, plain, lib in (
                    ("fwd", lambda: pw.pathway_fwd(x, p, plan), fwd_bytes,
                     lambda: pw.pathway_fwd_plain(x, p, plan), lib_fwd),
                    ("bwd", lambda: pw.pathway_bwd(x, p, gout, plan), bwd_bytes,
                     lambda: pw.pathway_bwd_plain(x, p, gout, plan), lib_bwd)):
                b_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ms, source = kernel_ms(fn, b_ms)
                row[side] = {"ms": ms, "source": source, "bound_ms": b_ms,
                             "bound_share": b_ms / ms, "plain_ms": cuda_ms(plain),
                             "library_ms": device_ms(lib)}
            del W, M
            row.update({"max_abs_err_vs_plain": {k: e for k, (e, _) in errs.items()},
                        "vs_dense": dense, "ok": ok})
            emit({"phase": "pathway", **row})
            if not ok:
                raise AssertionError(f"pathway {name} {dtype}: {row}")
            out[(name, row["dtype"])] = row
    return out


def launch_counts():
    return {k.name: k.launches for k in build.REGISTRY.values()}


def want_launches(nonzero=None):
    """{kernel name: launches} over every registered kernel: the counts
    named in nonzero, and 0 for every other kernel."""
    nonzero = nonzero or {}
    unknown = set(nonzero) - set(build.REGISTRY)
    if unknown:
        raise KeyError(f"not a registered kernel: {sorted(unknown)}")
    return {name: nonzero.get(name, 0) for name in build.REGISTRY}


def pw_launches(fwd=0, bwd=0):
    """The pathway contraction's PW launches as a launch dict's entries:
    a model forward outside torch.vmap launches its forward once, a train
    step its backward once more; under vmap (the stacked step) neither."""
    return {pw.FWD_KERNEL.name: fwd, pw.BWD_KERNEL.name: bwd}


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
    if (launches["composed"] != want_launches({k1.KERNEL.name: 2 * n, **pw_launches(n)})
            or launches["windowed"] != want_launches({k1.KERNEL.name: 2 * n,
                                                      k2.KERNEL.name: 2 * n,
                                                      **pw_launches(n)})):
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
    calls of step() under the profiler, which records the card's activity
    only (the host's op events cost ~0.2 ms each to record and sum, and a
    step of the foreach decoders has some 30,000)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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

    torch.cuda.reset_peak_memory_stats()
    ms, per_step = timed_steps(step, n_timed)
    peak = torch.cuda.max_memory_allocated()
    busy, n_kernels, rows = profiled(step, n_prof)
    step_ms = float(np.median(ms))
    ok = per_step == want_per_step
    emit({"phase": phase, "kernel_ms_per_step": busy, "peak_gb": peak / 1e9,
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
    gather's K1.  Every conv: the pathway contraction's PW forward a batch,
    and its backward a step."""
    batch, step = pw_launches(1), pw_launches(1, 1)
    if conv in ("mr", "edge"):
        return (want_launches({k3.KERNEL.name: 2, **batch}),
                want_launches({k3.KERNEL.name: 2, k1.KERNEL.name: 5, **step}))
    if conv == "gat":
        return (want_launches({k1.KERNEL.name: 4, **batch}),
                want_launches({k1.KERNEL.name: 13, **step}))
    res, tres = int(plan.n_res > 0), int(plan.n_tres > 0)
    return (want_launches({k1.KERNEL.name: 2 * res, k2.KERNEL.name: 2, **batch}),
            want_launches({k1.KERNEL.name: 2 * res + 2 * (tres + res) + 1,
                           k2.KERNEL.name: 4, **step}))


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
def pca_vs_plain(phase, m, ctx, batch, counted):
    """A runtime-PCA forward with plain versions, then counted(), the
    phase's counted eval_step with kernels: the rows the reduction takes
    within TOL_PCA_ROWS; the image's sign flips, its difference after the
    signs are aligned and the probabilities' difference are reported (they
    follow the solver).  The plain forward goes first, so the counted
    call is the model's second.  Returns counted()'s result."""
    rows, outs = [], []
    reduce = m.runtime_pca_image
    m.runtime_pca_image = lambda xg: (rows.append(xg), reduce(xg))[1]
    hook = m.register_forward_hook(
        lambda mod, inp, out: outs.append(tuple(t.detach() for t in out)))
    m.eval()
    try:
        with torch.no_grad(), spmm.plain_versions():
            m(batch, ctx)
        result = counted()
    finally:
        hook.remove()
        del m.runtime_pca_image
    torch.cuda.synchronize()
    (pp, ip), (pk, ik) = outs
    err, rmax = err_of(rows[1], rows[0])
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
    return result


def options_phase(cfg, ctx, batch):
    """Each option of OPTIONS on the sage path of the GBM fold: one eval
    forward with kernels against plain versions (forward_vs_plain's
    limits), launches counted over one eval_step (K2 2, the K1 residual 2
    and PW's forward, as sage; no PW for the PCA reductions); then, but for the PCA reductions, one step's gradients
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

        def counted():
            m.eval()
            torch.cuda.synchronize()
            zero_launches()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.no_grad():
                a.record()
                probs = eval_step(m, batch, ctx)[0]
                b.record()
            b.synchronize()
            return probs, launch_counts(), a.elapsed_time(b)

        if pca:
            probs, eval_launches, ms = pca_vs_plain(f"options_{name}", m, ctx, batch, counted)
        else:
            tol_img = TOL_IMAGE_BF16 if trunk == "bf16" else TOL_IMAGE_F32
            forward_vs_plain(f"options_{name}", ((trunk, tol_img, lambda: m),), ctx, batch)
            probs, eval_launches, ms = counted()
        row = {"phase": f"options_{name}_counts", "trunk": trunk, "eval_launches": eval_launches,
               "finite": bool(torch.isfinite(probs).all())}
        # the PCA reductions contract no learnable PCA: no PW launch
        ok = row["finite"] and eval_launches == (
            {**per_batch, **pw_launches()} if pca else per_batch)
        if pca:
            # the counted call, after the plain versions' forward: pca_svd's
            # 438 slots of batched SVDs take seconds on an H100
            row["forward_ms"] = ms
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


# the child process that writes cohort_phase's files (argv: root, the
# REF_COHORT keywords as JSON) and prints its write seconds
WRITER_CHILD = r"""
import json, sys, time
from multilevel_gnn_tpu_torch.data.synthetic import write_reference_format
t0 = time.perf_counter()
write_reference_format(sys.argv[1], cancer_type="gbm", **json.loads(sys.argv[2]))
print(json.dumps({"write_s": time.perf_counter() - t0}))
"""


def start_cohort_files(root):
    """cohort_phase's reference-format files written under root by a child
    process, so the writing (host only) runs beside the card's phases."""
    return subprocess.Popen([sys.executable, "-c", WRITER_CHILD, root, json.dumps(REF_COHORT)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=_child_env())


def cohort_phase(root, device="cuda", writer=None):
    """Reference-format files at reference scale, written by
    start_cohort_files' child (``writer``, started here when None) and
    waited for here, loaded with gbm.yaml, and fold 0's derivation, timed
    by stage."""
    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.data import native
    from multilevel_gnn_tpu_torch.data.loaders import load_cohort_from_files
    from multilevel_gnn_tpu_torch.train.driver import stratified_kfold

    t0 = time.perf_counter()
    writer = writer or start_cohort_files(root)
    out, err = writer.communicate(timeout=600)
    if writer.returncode != 0:
        raise AssertionError(f"cohort: the files' writer failed:\n{err[-4000:]}")
    t_write = _last_json(out)["write_s"]
    t_wait = time.perf_counter() - t0
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
    emit({"phase": "cohort", "write_s": t_write, "write_wait_s": t_wait, "load_s": t_load, "fold_s": t_fold,
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


EXPERIMENT_EPOCHS = 1  # the experiment phase's epochs on the files


def experiment_phase(root, device="cuda", yaml=GBM_YAML, phase="experiment", extra=None):
    """The train CLI's main on the reference-scale directory: 1 run x 5
    folds x EXPERIMENT_EPOCHS epochs under the config at yaml (its widths,
    bf16 trunk) on the card, counted.  extra: a callable returning (more of the
    phase's line, ok), read after the run."""
    from multilevel_gnn_tpu_torch.train import cli

    sync(device)
    zero_launches()
    t0 = time.perf_counter()
    res = cli.main(["--config", yaml, "--data-dir", root, "--device", device,
                    "--set", "num_run=1", f"epochs={EXPERIMENT_EPOCHS}"])
    sync(device)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    folds = res["folds"]
    want_k2 = any(f["windowed"] for f in folds)
    e = res["check_epochs"][-1]
    auc, acc = res["auc"][e], res["acc"][e]
    more, more_ok = extra() if extra is not None else ({}, True)
    ok = bool(len(folds) == 5 and launches[k1.KERNEL.name] > 0
          and (launches[k2.KERNEL.name] > 0) == want_k2
          and launches[k3.KERNEL.name] == 0 and launches[k4.name] == 0
          and 0.0 <= auc <= 1.0 and 0.0 <= acc <= 1.0 and more_ok)
    emit({"phase": phase, "config": Path(yaml).name, "wall_s": wall,
          "cli_wall_time_s": res["wall_time_s"],
          "fold_setup_s": [f["setup_s"] for f in folds],
          "fold_stage_s": [f["setup_stage_s"] for f in folds],
          "edges": [f["edges"] for f in folds], "windowed": [f["windowed"] for f in folds],
          "ms_per_step_median": [f["step_ms_median"] for f in folds],
          "host_s_per_epoch": [f["epoch_s"] for f in folds],
          "launches": launches, "epochs": e, "pooled_auc": auc, "pooled_acc": acc,
          **more, "ok": ok})
    if not ok:
        raise AssertionError(f"{phase} phase failed")
    return launches


def small_protocol_vs_cpu(yaml, phase, device="cuda"):
    """A small protocol (SMALL_COHORT, the config at yaml in f32 with
    dropout off, 2 epochs) on the card and on the CPU: every fold's test
    scores within TOL_PROTOCOL.  Returns {device: (fold results, result)}."""
    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.data.synthetic import make_synthetic_cohort
    from multilevel_gnn_tpu_torch.train import driver

    cfg = Config.from_yaml(yaml).replace(
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
    emit({"phase": phase, "config": Path(yaml).name, "fold_max_abs_err": errs,
          "tol": TOL_PROTOCOL, "pooled_auc_cuda": scores[device][1]["auc"][2],
          "pooled_auc_cpu": scores["cpu"][1]["auc"][2], "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: card vs CPU mismatch")
    return scores


# ---- the bf16 repairs, checkpoints, predict, explain, optimizers
# integrated gradients with kernels against plain versions, max|diff| /
# max|ref| over the (B, NODES) attributions: the limits of TOL_GRAD, since
# IG sums input gradients of the same forward and backward
TOL_IG = {"bf16": 7e-2, "f32": 6e-6}
TOL_OPTIM = 1e-5  # five radam / adamw steps, card against CPU (f32, small)
IG_STEPS = 16
CKPT_EPOCHS = 3


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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
PPI_EPOCHS = 1
# the child process that loads the artifacts, in the order given: each
# artifact's load seconds (the first one's from the process's start, torch's
# import and CUDA's start-up included; its first load also pays the loader's
# one-time imports), a second load, first-call seconds, probabilities,
# launches per call (counts zeroed just before one call), CUDA-event ms per
# call and its kernels' device ms.  Arguments: artifact dir, inputs .npz,
# and so on.
EXPORT_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
import numpy as np, torch
torch.cuda.init()
import_s = time.perf_counter() - t0
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from multilevel_gnn_tpu_torch.artifact import load_exported
from multilevel_gnn_tpu_torch.ops.kernels import build
out = []
args = sys.argv[1:]
for i in range(0, len(args), 2):
    t1 = time.perf_counter()
    infer = load_exported(args[i])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0 if i == 0 else None
    load_exported_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    load_exported(args[i])
    torch.cuda.synchronize()
    load_again_s = time.perf_counter() - t1
    z = np.load(args[i + 1])
    x = torch.as_tensor(z["x"], device="cuda")
    age = torch.as_tensor(z["age"], device="cuda")
    t1 = time.perf_counter()
    infer(x, age)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
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
        windows.append(sum(getattr(ev, "self_device_time_total", 0.0)
                           for ev in prof.key_averages()
                           if ev.device_type == DeviceType.CUDA
                           and not getattr(ev, "is_user_annotation", False)) / 1e3 / 10)
    out.append({"load_s": load_s, "import_torch_s": import_s, "load_order": i // 2,
                "load_exported_s": load_exported_s, "load_again_s": load_again_s,
                "first_call_s": first_s, "probs": p.cpu().tolist(),
                "launches": launches, "event_ms_median": float(np.median(ms)),
                "device_ms": float(np.median(windows))})
    del infer
print(json.dumps(out))
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
    res = wp.res
    cases = [
        ("segment_spmm_csr", k1.segment_spmm_csr_op, (x, w) + csr.op_args),
        ("segment_spmm_csr_acc", k1.segment_spmm_csr_acc_op,
         (rand(N, 64, dtype=torch.float32), x, w) + res.op_args + (res.n_busy,)),
        ("windowed_tile_spmm", k2.windowed_tile_spmm_op, (x, w) + k2._side_args(wp, False)),
        ("windowed_tile_spmm_transpose", k2.windowed_tile_spmm_op,
         (x, w) + k2._side_args(wp, True)),
        ("segment_max_csr", k3.segment_max_csr_op, (rand(E, 64), csr.rowptr, csr.eid, csr.row)),
        ("sorted_segment_sum", k1.sorted_segment_sum_op,
         (rand(2, E, 16), splan.rowptr, None, splan.seg)),
        ("sorted_segment_sum_perm", k1.sorted_segment_sum_op,
         (rand(2, E, 16), splan.rowptr, splan.perm, splan.seg)),
        ("dma_row_gather", p1.dma_row_gather_op,
         (rand(64, 16, 128), torch.randint(0, 64, (1000,), generator=gen, device="cuda",
                                           dtype=torch.int32), p1.TE)),
    ]
    seconds = {}
    for name, op, args in cases:
        t0 = time.perf_counter()
        torch.library.opcheck(op, args)  # raises on a failed check
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    emit({"phase": "ops", "checked": list(seconds), "seconds": seconds, "ok": True})


def export_save(model, ctx, batch, root, phase="export", want=None):
    """A GBM fold's eval forward exported (torch.export) and saved under
    root/<phase>, with the live eval_step's probabilities and launches on
    the same batch (want: K1 2 / K2 2, sage's, when None), the live call's
    CUDA-event and device ms, and the program's mgtpu ops: a pending
    export_check record."""
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
    out = f"{root}/{phase}"
    save_exported(out, {"program": program, "meta": meta})
    del program
    np.savez(f"{out}.npz", x=batch.x.cpu().numpy(), age=batch.age.cpu().numpy())
    return {"phase": phase, "dir": out, "inputs": f"{out}.npz", "live": live.cpu().numpy(),
            "live_launches": live_launches,
            "want": want or want_launches({k1.KERNEL.name: 2, k2.KERNEL.name: 2,
                                           **pw_launches(1)}),
            "line": {"phase": phase, "gnn_name": model.cfg.gnn_name, "n_nodes": n_nodes,
                     "n_edges": ctx.graph.n_edges, "batch": B, "export_s": export_s,
                     "artifact_bytes": _dir_bytes(out), "n_tensors": meta["n_tensors"],
                     "live_event_ms": live_event_ms, "live_device_ms": live_device_ms,
                     "mgtpu_ops_in_graph": {k: v for k, v in targets.items() if "mgtpu" in k},
                     "auto_functionalized_nodes": sum(
                         v for k, v in targets.items() if "auto_functionalized" in k)}}


def export_check(pending):
    """export_save's artifacts loaded in one fresh process, in order: each
    one's probabilities against its live eval_step within TOL_EXPORT x
    max(1, max|ref|), its launches per call equal to the live call's and
    to its want, its load and first-call seconds, and the device ms of an
    exported call against a live one; one line each.  Returns [launches
    per exported call]."""
    args = [a for rec in pending for a in (rec["dir"], rec["inputs"])]
    r = subprocess.run([sys.executable, "-c", EXPORT_CHILD, *args],
                       capture_output=True, text=True, env=_child_env(), timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"export: the artifacts' process failed:\n{r.stderr[-4000:]}")
    children = _last_json(r.stdout)
    order = [rec["phase"] for rec in pending]
    for rec, child in zip(pending, children):
        ref, got = rec["live"], np.asarray(child["probs"])
        err = float(np.abs(got - ref).max())
        lim = TOL_EXPORT * max(1.0, float(np.abs(ref).max()))
        ok = (got.shape == ref.shape and err <= lim and child["launches"] == rec["live_launches"]
              and rec["live_launches"] == rec["want"])
        emit({**rec["line"], "child_loads": order,
              **{k: child[k] for k in ("load_order", "load_s", "import_torch_s",
                                       "load_exported_s", "load_again_s", "first_call_s")},
              "max_abs_err": err, "tol": lim, "equal_bits": bool(np.array_equal(got, ref)),
              "launches_per_call": child["launches"],
              "live_launches_per_call": rec["live_launches"],
              "event_ms": child["event_ms_median"], "device_ms": child["device_ms"],
              "ok": ok})
        if not ok:
            raise AssertionError(f"{rec['phase']}: the exported call differs from the live one")
    return [child["launches"] for child in children]


def export_phase(model, ctx, batch, phase="export", want=None):
    """export_save and export_check of one fold: the launches per exported
    call."""
    with tempfile.TemporaryDirectory() as root:
        return export_check([export_save(model, ctx, batch, root, phase, want)])[0]


def warm_phase():
    """The warm CLI in a fresh copy of the package (nothing built), then
    the train CLI from the same copy with --bench-scaling (the
    bench_scaling phase's run): it must find every kernel and data library
    built (0.0 s each).  Returns (the bench's line, its process s)."""
    import shutil

    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(REPO / "multilevel_gnn_tpu_torch", Path(tmp) / "multilevel_gnn_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        env = dict(os.environ, PYTHONPATH=tmp)
        out = {}
        for name, module, args in (
                ("warm", "multilevel_gnn_tpu_torch.train.warm",
                 ["--config", GBM_YAML, "--synthetic", "--debug"]),
                ("train", "multilevel_gnn_tpu_torch.train.cli",
                 ["--config", GBM_YAML, "--synthetic", "--bench-scaling"])):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", module, *args],
                               capture_output=True,
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
    return train, train_wall


def profile_phase(root):
    """The train CLI with --profile-dir on the small protocol files under
    root (1 run x 5 folds x 1 epoch) against the same protocol without it,
    run first: the trace's bytes and K1's kernel symbol in it, and both
    wall times."""
    from multilevel_gnn_tpu_torch.train import cli
    from multilevel_gnn_tpu_torch.utils.profiling import TRACE_FILE

    args = ["--config", GBM_YAML, "--data-dir", root, "--set", "num_run=1", "epochs=1"]
    walls = {}
    for name, extra in (("plain", []), ("profiled", ["--profile-dir", f"{root}/prof"])):
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
    one; the PCA gather's backward (K1); the pathway contraction's PW
    forward and backward."""
    want = want_launches({k1.KERNEL.name: 1, **pw_launches(1, 1)})
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
DGCN_EPOCHS = 1


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
    want = want_launches({k3.KERNEL.name: L * n_batches})
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
    want_step = want_launches({k1.KERNEL.name: L + 1, k3.KERNEL.name: L})
    torch.cuda.reset_peak_memory_stats()
    per_step, step_kernel_ms = profile_train(model, ctx, batch, cw, want_step,
                                             phase="profile_train_deepergcn")
    emit({"phase": "train_mem_deepergcn", "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "edge_tensor_gb": ctx.graph.num_padded_edges * B * H * 2 / 1e9})
    explain = dgcn_explain_phase(model, ctx, batch)
    del model, batch
    torch.cuda.empty_cache()
    s11 = slice11_phases(fcfg, fold, X, tr, cohort, gen)
    del fold, ctx
    torch.cuda.empty_cache()
    experiment, peak = dgcn_experiment_phase(root)
    torch.cuda.empty_cache()
    return dict(serve=serve, experiment=experiment, per_step=per_step, r3=r3, r1=r1,
                step_kernel_ms=step_kernel_ms, explain=explain, s11=s11)


# ---- MultiOmixGCN on the DeeperGCN fold; DeeperGCN's explain; the
# dynamic-graph blocks, MiNet and the dense blocks

# whole forwards, kernels against plain versions (f32 trunk): max runs K3
# only, which selects one of its inputs, so the forward and the step's
# gradients are held to the plain ones (equal; TOL_F32).  softmax's weights
# are shifted by their column's largest value, as JAX's pallas form does,
# and a segment whose sum of exp lies at the edge of underflow gets weight
# 0 from a sum of 0 and weights near 1 from a sum of one subnormal: the
# 1e-7 differences of K1's sum order in one layer flip such segments in
# the next (an H100 read 0.105 on the probabilities).  There each K1 call
# of the forward and the step is held to its plain version on the same
# inputs (PerCall) and the whole-forward difference is reported.
TOL_PROB_MO = {"max": 0.0}
MO_GRAD_BATCHES = (32, 16, 8, 4)  # the gradient's B: the largest that fits
DYN_N, DYN_C, DYN_K = 15_405, 64, 9  # node slots, channels, the reference's k
MINET = dict(in_nodes=15_405, gene_nodes=5_135, pathway_nodes=146)
TOL_CARD_CPU = 1e-4  # times max(1, max|ref|): dense f32 products, card against CPU


class PerCall:
    """Inside this block every K1, K2 and K3 call that ops.spmm makes with
    its kernel is held against the plain version on the same inputs: K3
    equal, K1 and K2 within TOL_F32 (TOL_BF16 for bf16 rows) times max(1,
    max|ref|).  A windowed SpMM's K2 call and each of its residual K1
    calls are held on their own: the kernel entry points that
    windowed_spmm calls are wrapped, so its own composition runs.
    ``worst`` is the largest reading of each, ``tiny`` the K1 output
    entries above 0 and below 1e-30 (sums of exp at the edge of
    underflow)."""

    def __enter__(self):
        self.real = (spmm._k1, spmm._k2, spmm._k3)
        self.real_windowed = (k2.windowed_tile_spmm, k2.segment_spmm_csr)
        self.worst = {k1.KERNEL.name: 0.0, k2.KERNEL.name: 0.0, k3.KERNEL.name: 0.0}
        self.calls = Counter()
        self.tiny = 0
        real_k1, _, real_k3 = self.real

        def k1_call(x, w, plan, out=None):
            base = out.clone() if out is not None else None
            got = k1.segment_spmm_csr(x, w, plan, out)
            ref = k1.segment_spmm_csr_plain(x, w, plan, base)
            tol = TOL_BF16 if x.dtype == torch.bfloat16 else TOL_F32
            self._record(k1.KERNEL.name, got, ref, tol)
            self.tiny += int(((ref.abs() > 0) & (ref.abs() < 1e-30)).sum())
            return got

        def k1_both(plain):
            return real_k1(plain) if plain else k1_call

        real_tile, _ = self.real_windowed

        def k2_call(x, w, plan, transpose=False):
            got = real_tile(x, w, plan, transpose)
            ref = k2.windowed_tile_spmm_plain(x, w, plan, transpose)
            tol = TOL_BF16 if x.dtype == torch.bfloat16 else TOL_F32
            self._record(k2.KERNEL.name, got, ref, tol)
            return got

        def k3_both(plain):
            fn = real_k3(plain)
            if plain:
                return fn

            def both(msg, plan):
                got = fn(msg, plan)
                self._record(k3.KERNEL.name, got, k3.segment_max_csr_plain(msg, plan), 0.0)
                return got
            return both

        spmm._k1, spmm._k3 = k1_both, k3_both
        k2.windowed_tile_spmm, k2.segment_spmm_csr = k2_call, k1_call
        return self

    def _record(self, name, got, ref, tol):
        e, m = err_of(got, ref)
        rel = e / max(1.0, m)
        self.calls[name] += 1
        self.worst[name] = max(self.worst[name], rel)
        if not rel <= tol:
            raise AssertionError(f"{name} call {self.calls[name]}: {rel} against plain > {tol}")

    def __exit__(self, *exc):
        spmm._k1, spmm._k2, spmm._k3 = self.real
        k2.windowed_tile_spmm, k2.segment_spmm_csr = self.real_windowed
        return False

    def summary(self):
        return {"calls": dict(self.calls), "worst_rel_err": self.worst,
                "tiny_sums": self.tiny}


def expect_launches(phase, got, want):
    if got != want:
        raise AssertionError(f"{phase}: launches {got}, the code predicts {want}")


def mo_launches(cfg, n_batches=1, step=False):
    """K1 / K3 launches the code predicts for MultiOmixGCN: each omics
    encoder runs L GENConvs and, under res+, L - 1 PathwayConvs; each conv's
    max aggregation is one K3, its softmax two K1 (the denominators and the
    weighted sum; the weights take no gradient unless t is learned, and
    then their gather adds one K1 backward); a step adds each conv's
    gather_src backward (K1)."""
    L = cfg.num_layers
    convs = 3 * (L + (L - 1 if cfg.block == "res+" else 0))
    soft = cfg.gcn_aggr in ("softmax", "softmax_sg", "softmax_sum")
    n_k1 = 2 * convs if soft else 0
    if step:
        n_k1 += convs + (convs if soft and cfg.learn_t and cfg.gcn_aggr != "softmax_sg" else 0)
    return want_launches({k1.KERNEL.name: n_k1 * n_batches,
                          k3.KERNEL.name: (convs if cfg.gcn_aggr == "max" else 0) * n_batches})


def mo_batches(X, attrs, cohort, idx, B):
    """(Batch, pathway attrs by omics) of idx in chunks of B on the card,
    the last padded; the three omics' (P, 2) attrs ride raw_data side by
    side."""
    from multilevel_gnn_tpu_torch.models.multiomix import OMIX_NAMES
    from multilevel_gnn_tpu_torch.train.driver import iter_batches

    raw = np.concatenate([attrs[o].cpu().numpy() for o in OMIX_NAMES], axis=-1)
    for b in iter_batches(X, cohort.Y, cohort.ages, idx, B, "cuda", raw):
        yield b, {o: b.raw_data[..., 2 * i: 2 * i + 2].contiguous()
                  for i, o in enumerate(OMIX_NAMES)}


def mo_fold_phase(cohort, fold):
    """Cohort.multiomix_vnode_data on the DeeperGCN fold: per omics its
    gene -> pathway-vnode edges, the pathway rows they reach, seconds."""
    from multilevel_gnn_tpu_torch.models.multiomix import VnodeContext

    t0 = time.perf_counter()
    graphs, masks, attrs = cohort.multiomix_vnode_data(fold, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    edges = {o: g.n_edges for o, g in graphs.items()}
    reached = {o: int(m.sum()) for o, m in masks.items()}
    ok = all(e > 0 for e in edges.values()) and all(
        0 < r <= cohort.n_pathways for r in reached.values())
    emit({"phase": "multiomix_fold", "seconds": dt, "edges": edges,
          "pathway_rows_reached": reached, "attrs_shape": list(attrs["mrna"].shape), "ok": ok})
    if not ok:
        raise AssertionError("multiomix_fold phase failed")
    return VnodeContext(fold.ctx, graphs, masks), attrs


def mo_kernel_phase(vctx, B, H, gen):
    """The K3 / K1 forms of the pathway-vnode graph (mrna's) at F = B*H in
    float32: K3 over its csr, K1 as edge_segment_sum's forward (softmax's
    sums) and as gather_src's backward, against plain versions."""
    g = vctx.pathway_graphs["mrna"]
    E = g.num_padded_edges
    msg = torch.randn(E, B * H, generator=gen, device="cuda")
    r3 = {"vnode": {**time_k3(g, msg), "case": f"vnode csr F={B * H}"}}
    emit({"phase": "k3_vnode", **r3["vnode"]})
    ones = torch.ones(E, device="cuda")
    r1 = {}
    for case, plan in (("vnode_edge_segment_sum", g.dst_gather),
                       ("vnode_gather_src_bwd", g.src_gather)):
        r1[case] = time_k1(case, plan, msg, ones, False, gen)
        emit({"phase": "k1_vnode", **r1[case]})
    return r3, r1


def mo_serve_phase(model, vctx, X, attrs, cohort):
    """The eval forward over the N_PATIENTS serving patients in batches of
    the config's B, counted (zeroed just before, read just after) against
    mo_launches; every batch's probabilities with kernels against plain
    versions; host ms a batch and profiler device ms of one full batch."""
    cfg = model.cfg
    batches = list(mo_batches(X, attrs, cohort, np.arange(N_PATIENTS), cfg.batch_size))
    model.eval()
    with torch.no_grad():
        model(batches[0][0], vctx, batches[0][1])  # warm-up
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        probs = [model(b, vctx, a)[0] for b, a in batches]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        with spmm.plain_versions():
            refs = [model(b, vctx, a)[0] for b, a in batches]
        with PerCall() as calls:
            for b, a in batches:
                model(b, vctx, a)
        busy, n_kernels, rows = profiled(lambda: model(batches[0][0], vctx, batches[0][1]))
    err = max(float((p - r).abs().max()) for p, r in zip(probs, refs))
    want = mo_launches(cfg, len(batches))
    prob = torch.cat([p[b.sample_mask] for p, (b, _) in zip(probs, batches)])
    tol = TOL_PROB_MO.get(cfg.gcn_aggr)
    ok = (prob.shape == (N_PATIENTS, 2) and bool(torch.isfinite(prob).all())
          and float((prob.sum(-1) - 1).abs().max()) < 1e-5 and (tol is None or err <= tol))
    phase = f"serve_multiomix_{cfg.gcn_aggr}"
    emit({"phase": phase, "batches": len(batches), "patients": N_PATIENTS,
          "ms_per_batch": wall * 1e3 / len(batches), "kernel_ms_per_batch": busy,
          "kernels_per_batch": n_kernels, "port_kernel_ms_per_batch": port_kernel_ms(rows),
          "launches": launches, "launches_expected": want,
          "max_abs_err_prob_vs_plain": err, "tol": tol, "per_call": calls.summary(),
          "top": top_rows(rows, 10), "ok": ok})
    if not ok:
        raise AssertionError(f"{phase} phase failed")
    expect_launches(phase, launches, want)
    return launches


def mo_grads(model, vctx, batch, attrs, cw):
    """One training-mode class-weighted BCE's loss and gradients (dropout
    masks from a generator seeded alike on every call)."""
    from multilevel_gnn_tpu_torch.train.step import classification_loss

    model.train()
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    pred, _ = model(batch, vctx, attrs, gen)
    loss = classification_loss(pred, batch.y, cw, batch.sample_mask, model.cfg)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def mo_grad_phase(model, vctx, X, attrs, cohort, tr, cw):
    """One step's gradients at the largest B of MO_GRAD_BATCHES that fits,
    counted against mo_launches(step=True), device ms and peak memory;
    every kernel call of the step against its plain version on the same
    inputs (PerCall); then the step with plain versions: per parameter
    max|diff| / max|grad|, within TOL_F32 for max (reported for softmax,
    see TOL_PROB_MO)."""
    cfg = model.cfg
    tried = []
    for B in MO_GRAD_BATCHES:
        batch, a = next(mo_batches(X, attrs, cohort, tr, B))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            zero_launches()
            loss_k, gk = mo_grads(model, vctx, batch, a, cw)
            torch.cuda.synchronize()
            launches = launch_counts()
            peak = torch.cuda.max_memory_allocated() / 1e9
            step_ms = cuda_ms(lambda: mo_grads(model, vctx, batch, a, cw), iters=3, warmup=1)
            break
        except torch.OutOfMemoryError:
            tried.append(B)
            model.zero_grad(set_to_none=True)
    else:
        raise AssertionError(f"train_grad_multiomix: no B of {MO_GRAD_BATCHES} fits")
    with PerCall() as calls:
        mo_grads(model, vctx, batch, a, cw)
    with spmm.plain_versions():
        loss_p, gp = mo_grads(model, vctx, batch, a, cw)
    torch.cuda.synchronize()
    rel = {n: float((gk[n] - gp[n]).abs().max()) / max(float(gp[n].abs().max()), 1e-30)
           for n in gp}
    worst = max(rel, key=rel.get)
    names = {n for n, _ in model.named_parameters()}
    want = mo_launches(cfg, step=True)
    phase = f"train_grad_multiomix_{cfg.gcn_aggr}"
    tol = TOL_F32 if cfg.gcn_aggr in TOL_PROB_MO else None
    ok = (set(gk) == set(gp) == names
          and all(bool(torch.isfinite(g).all()) for g in gk.values())
          and (tol is None or (rel[worst] <= tol
                               and abs(loss_k - loss_p) <= tol * max(1.0, abs(loss_p)))))
    emit({"phase": phase, "batch": B, "batches_out_of_memory": tried, "loss": loss_k,
          "loss_plain": loss_p, "worst_param": worst, "worst_rel_err": rel[worst],
          "tol": tol, "per_call": calls.summary(),
          "launches_per_step": launches, "launches_expected": want,
          "step_event_ms": step_ms, "peak_mem_gb": peak,
          "edge_tensor_gb": vctx.base.graph.num_padded_edges * B * cfg.hidden_channels * 4 / 1e9,
          "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: kernels against plain versions")
    expect_launches(phase, launches, want)
    return launches


def mo_phases(fcfg, fold, X, tr, cohort, gen):
    """MultiOmixGCN at gbm.yaml's DeeperGCN widths (H = 128, 3 layers,
    res+, layer norm, maxpool readout, pathway nodes; f32), served and
    differentiated with gcn_aggr max, then softmax."""
    from multilevel_gnn_tpu_torch.models.multiomix import MultiOmixGCN

    vctx, attrs = mo_fold_phase(cohort, fold)
    r3, r1 = mo_kernel_phase(vctx, fcfg.batch_size, fcfg.hidden_channels, gen)
    cw = torch.as_tensor(fold.class_weight, dtype=torch.float32, device="cuda")
    serve, per_step = {}, {}
    for aggr in ("max", "softmax"):
        cfg = fcfg.replace(model="multiomix", gcn_aggr=aggr)
        model = MultiOmixGCN.for_vnode_data(cfg, vctx.pathway_graphs, attrs, device="cuda")
        serve[f"serve_multiomix_{aggr}"] = mo_serve_phase(model, vctx, X, attrs, cohort)
        per_step[f"multiomix_{aggr}"] = mo_grad_phase(model, vctx, X, attrs, cohort, tr, cw)
        del model
        torch.cuda.empty_cache()
    return dict(serve=serve, per_step=per_step, r3=r3, r1=r1)


def dgcn_explain_phase(model, ctx, batch):
    """integrated_gradients of DeeperGCN (IG_STEPS steps, B = 32, bf16
    trunk, gcn_aggr max) on its fold: launches per call against the code's
    (each step K3 once a layer forward and K1 once a layer for gather_src's
    backward; the frozen edge-id table takes none), device ms, peak memory,
    kernels against plain versions (TOL_IG); then pathway_attributions
    raises IndexError, as the JAX package's does."""
    from multilevel_gnn_tpu_torch.train.explain import integrated_gradients, pathway_attributions

    integrated_gradients(model, batch, ctx, steps=2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_launches()
    ig = integrated_gradients(model, batch, ctx, steps=IG_STEPS)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    busy, _, rows = profiled(lambda: integrated_gradients(model, batch, ctx, steps=IG_STEPS), 1)
    with spmm.plain_versions():
        ref = integrated_gradients(model, batch, ctx, steps=IG_STEPS)
    torch.cuda.synchronize()
    e, m = err_of(ig, ref)
    trunk = "bf16" if model.cfg.compute_dtype else "f32"
    L = model.cfg.num_layers
    want = want_launches({k1.KERNEL.name: L * IG_STEPS, k3.KERNEL.name: L * IG_STEPS})
    try:
        pathway_attributions(ig, ctx, model.cfg.pathway_num)
        raised = None
    except IndexError as exc:
        raised = str(exc)
    ok = (bool(torch.isfinite(ig).all()) and tuple(ig.shape) == tuple(batch.x.shape)
          and m > 0 and e <= TOL_IG[trunk] * m and raised is not None)
    emit({"phase": "explain_deepergcn", "steps": IG_STEPS, "batch": int(batch.x.shape[0]),
          "trunk": trunk, "launches_per_call": launches, "launches_expected": want,
          "device_ms_per_call": busy, "port_kernel_ms_per_call": port_kernel_ms(rows),
          "peak_mem_mib": peak / 2**20, "max_abs_err_vs_plain": e, "ref_max": m,
          "tol_rel": TOL_IG[trunk], "pathway_attributions_raised": raised,
          "top": top_rows(rows, 8), "ok": ok})
    if not ok:
        raise AssertionError("explain_deepergcn phase failed")
    expect_launches("explain_deepergcn", launches, want)
    return launches


def dyn_phase(gen):
    """DynConv and ResDynBlock (conv edge) at N = DYN_N, C = DYN_C, k =
    DYN_K: the kNN graph and its plans built on the card with synchronising
    calls set to raise; forward and backward counted (K3 once, K1 twice:
    the two edge gathers' backwards) and timed, against plain versions
    (output equal, gradients within TOL_F32 of each one's largest); then
    the K3 and K1 forms of the kNN plan."""
    from multilevel_gnn_tpu_torch.nn.blocks import DynConv, ResDynBlock
    from multilevel_gnn_tpu_torch.nn.conv import dynamic_graph
    from multilevel_gnn_tpu_torch.ops.knn import knn_graph

    x = torch.randn(DYN_N, DYN_C, generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        s, r = knn_graph(x, DYN_K)
        graph = dynamic_graph(s, r, DYN_N)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    counts = {}
    want = want_launches({k1.KERNEL.name: 2, k3.KERNEL.name: 1})
    for name, blk in (("DynConv", DynConv(DYN_C, DYN_C, DYN_K)),
                      ("ResDynBlock", ResDynBlock(DYN_C, DYN_K))):
        blk = blk.to("cuda")
        cot = torch.randn(DYN_N, DYN_C, generator=gen, device="cuda")

        def run():
            xi = x.clone().requires_grad_(True)
            blk.zero_grad(set_to_none=True)
            out = blk(xi)
            out.backward(cot)
            return out.detach(), xi.grad, {n: p.grad for n, p in blk.named_parameters()}

        run()
        torch.cuda.synchronize()
        zero_launches()
        out, dx, grads = run()
        torch.cuda.synchronize()
        counts[name] = launch_counts()
        with spmm.plain_versions():
            out_p, dx_p, grads_p = run()
        rel = {n: float((grads[n] - grads_p[n]).abs().max()) / max(
            float(grads_p[n].abs().max()), 1e-30) for n in grads_p}
        rel["x"] = float((dx - dx_p).abs().max()) / max(float(dx_p.abs().max()), 1e-30)
        ms = device_ms(run, iters=3)
        ok = bool(torch.equal(out, out_p)) and max(rel.values()) <= TOL_F32
        emit({"phase": f"dyn_{name}", "n": DYN_N, "c": DYN_C, "k": DYN_K,
              "edges": graph.n_edges, "knn_plans_ms": build_ms,
              "launches_fwd_bwd": counts[name], "launches_expected": want,
              "out_equal_plain": bool(torch.equal(out, out_p)),
              "grad_rel_err": max(rel.values()), "tol": TOL_F32,
              "device_ms_fwd_bwd": ms, "ok": ok})
        if not ok:
            raise AssertionError(f"dyn_{name}: kernels against plain versions")
        expect_launches(f"dyn_{name}", counts[name], want)
    r3 = {"knn": {**time_k3(graph, torch.randn(graph.n_edges, DYN_C, generator=gen,
                                                device="cuda")), "case": f"knn csr F={DYN_C}"}}
    emit({"phase": "k3_knn", **r3["knn"]})
    g = torch.randn(graph.n_edges, DYN_C, generator=gen, device="cuda")
    ones = torch.ones(graph.n_edges, device="cuda")
    r1 = {}
    for case, plan in (("knn_gather_src_bwd", graph.src_gather),
                       ("knn_gather_dst_bwd", graph.dst_gather)):
        r1[case] = time_k1(case, plan, g, ones, False, gen)
        emit({"phase": "k1_knn", **r1[case]})
    return counts["DynConv"], r3, r1


def minet_phase():
    """OmicsNet at the cohort's sizes (MINET, B = 32, hidden 64 / 16) with
    seeded connection masks (each gene its three omics inputs, each pathway
    38 genes): the eval forward, and a training step with dropout masks
    (scores, Cox loss, the moved running statistics, every gradient) on
    the card against the CPU within TOL_CARD_CPU; the card's step ms."""
    from multilevel_gnn_tpu_torch.models.minet import OmicsNet, dropout_mask, neg_partial_log_likelihood

    I, G, P = MINET["in_nodes"], MINET["gene_nodes"], MINET["pathway_nodes"]
    rng = np.random.RandomState(6)
    gm = np.zeros((G, I), np.float32)
    gm[np.repeat(np.arange(G), 3), rng.randint(0, I, 3 * G)] = 1.0
    pm = np.zeros((P, G), np.float32)
    pm[np.repeat(np.arange(P), 38), rng.randint(0, G, 38 * P)] = 1.0
    data = dict(x=rng.randn(32, I).astype(np.float32), age=rng.rand(32).astype(np.float32),
                gm=gm, pm=pm, m1=dropout_mask(rng, P, 0.3), m2=dropout_mask(rng, 64, 0.2))
    time_ = rng.randint(1, 60, 32).astype(np.float32)
    event = (rng.rand(32) < 0.7).astype(np.float32)
    cpu = OmicsNet(I, G, P, device="cpu", seed=0)
    card = copy.deepcopy(cpu).to("cuda")
    out = {}
    for dev, m in (("cpu", cpu), ("cuda", card)):
        t = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
        m.eval()
        with torch.no_grad():
            ev = m(t["x"], t["age"], t["gm"], t["pm"])
        m.train()

        def step():
            m.zero_grad(set_to_none=True)
            risk = m(t["x"], t["age"], t["gm"], t["pm"], t["m1"], t["m2"], (0.3, 0.2))
            loss = neg_partial_log_likelihood(risk, torch.as_tensor(time_, device=dev),
                                              torch.as_tensor(event, device=dev))
            loss.backward()
            return risk, loss

        risk, loss = step()
        out[dev] = dict(eval=ev.cpu(), risk=risk.detach().cpu(), loss=float(loss.detach()),
                        grads={n: p.grad.cpu() for n, p in m.named_parameters()},
                        stats={n: b.cpu() for n, b in m.named_buffers()})
    errs = {"eval": err_of(out["cuda"]["eval"], out["cpu"]["eval"]),
            "risk": err_of(out["cuda"]["risk"], out["cpu"]["risk"])}
    for kind in ("grads", "stats"):
        for n, v in out["cpu"][kind].items():
            errs[f"{kind}:{n}"] = err_of(out["cuda"][kind][n], v)
    worst = max(errs, key=lambda k: errs[k][0] / max(1.0, errs[k][1]))
    ok = (all(e <= TOL_CARD_CPU * max(1.0, m) for e, m in errs.values())
          and abs(out["cuda"]["loss"] - out["cpu"]["loss"]) <= TOL_CARD_CPU * max(
              1.0, abs(out["cpu"]["loss"])))
    card.train()
    t = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    yt, ye = torch.as_tensor(time_, device="cuda"), torch.as_tensor(event, device="cuda")

    def card_step():
        card.zero_grad(set_to_none=True)
        risk = card(t["x"], t["age"], t["gm"], t["pm"], t["m1"], t["m2"], (0.3, 0.2))
        neg_partial_log_likelihood(risk, yt, ye).backward()

    emit({"phase": "minet", **MINET, "batch": 32, "loss": out["cuda"]["loss"],
          "loss_cpu": out["cpu"]["loss"], "worst": worst, "worst_err": errs[worst][0],
          "worst_ref_max": errs[worst][1], "tol": TOL_CARD_CPU,
          "step_device_ms": device_ms(card_step, iters=5), "ok": ok})
    if not ok:
        raise AssertionError("minet: card against CPU")


def dense_blocks_phase(gen):
    """ResDynBlock2d and DenseDynBlock2d (edge conv, batch norm in eval) on
    a (2, 64, 2048, 1) cloud, k 9: on one kNN edge index, the card against
    the CPU within TOL_CARD_CPU; the card's forward with its own kNN, and
    its device ms."""
    from multilevel_gnn_tpu_torch.nn.dense_blocks import (
        DenseDynBlock2d,
        ResDynBlock2d,
        dense_knn_matrix,
    )

    x = torch.randn(2, 64, 2048, 1, generator=gen, device="cuda")
    ei = dense_knn_matrix(x, 9)
    for name, make in (("ResDynBlock2d", lambda: ResDynBlock2d(64, 9, norm="batch")),
                       ("DenseDynBlock2d", lambda: DenseDynBlock2d(64, 32, 9, norm="batch"))):
        torch.manual_seed(0)
        cpu = make().eval()
        card = copy.deepcopy(cpu).to("cuda").eval()
        with torch.no_grad():
            ref = cpu(x.cpu(), ei.cpu())
            got = card(x, ei)
            own = card(x)
        e, m = err_of(got.cpu(), ref)
        ms = device_ms(lambda: card(x), iters=5)
        ok = e <= TOL_CARD_CPU * max(1.0, m) and bool(torch.isfinite(own).all())
        emit({"phase": f"dense_{name}", "shape": list(x.shape), "k": 9,
              "max_abs_err_vs_cpu": e, "ref_max": m, "tol": TOL_CARD_CPU,
              "out_shape": list(own.shape), "device_ms": ms, "ok": ok})
        if not ok:
            raise AssertionError(f"dense_{name}: card against CPU")


def slice11_phases(fcfg, fold, X, tr, cohort, gen):
    """MultiOmixGCN on the DeeperGCN fold, then the dynamic-graph blocks,
    MiNet and the dense blocks."""
    t0 = time.perf_counter()
    mo = mo_phases(fcfg, fold, X, tr, cohort, gen)
    torch.cuda.empty_cache()
    dyn, r3, r1 = dyn_phase(gen)
    minet_phase()
    dense_blocks_phase(gen)
    torch.cuda.empty_cache()
    emit({"phase": "slice11", "seconds": time.perf_counter() - t0})
    mo["r3"].update(r3)
    mo["r1"].update(r1)
    mo["per_step"]["dyn_conv"] = dyn
    return mo


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
    serving the N_PATIENTS and PRETRAIN_STEPS train steps, each counted (with
    learnable PCA the pathway contraction's PW forward a batch and backward
    a step; no other port kernel)."""
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
        n_pw = int(learnable)
        ok = ok and serve == {**zero_counts(), **pw_launches(4 * n_pw)} and per_step == {
            **zero_counts(), **pw_launches(n_pw, n_pw)} and bool(np.isfinite(losses).all())
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
    ok = bool({**pl, **pw_launches()} == zero_counts() and pl[pw.FWD_KERNEL.name] > 0
              and np.isfinite(res["auc"][2]))
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
        "autoencoder", cfg, ctx, batch, decoder="foreach", n_steps=2)
    for head, (sv, st) in vae_finetune_phase(cfg, ctx, batch).items():
        serve[f"serve_vae_finetune_{head}"] = sv
        per_step[f"vae_finetune_{head}"] = st
    return serve, per_step


# ---- fold-parallel CV (train/fold_parallel.py): the protocol's units in one
# stacked step, K1 / K2 / K3 launched once per SpMM or segment op for all of
# them over block-diagonal plans (core/graph.py:stack_graphs)
FP_UNITS = 5
FP_PROTOCOL_EPOCHS = 1  # fold_parallel_protocol's epochs on the files
# calls a profiled window of the stacked forms' plain versions and library
# calls, which take 30-70 ms each at U = 5 (10 for the other forms)
FP_SLOW_REPS = 3
FP_STEPS = 6  # timed stacked steps (and timed sequences of five unit steps)
# a stacked eval batch's probabilities against each unit's own eval_step
# (its dense layers batched GEMMs, its head a grouped convolution, summing
# in other orders than the unit's own).  Reading on an H100 (PERF.md):
# 2.4e-7 in both trunks; the limit about forty times.
TOL_FP_PROB = {"bf16": 1e-5, "f32": 1e-5}


def fp_units(n=FP_UNITS):
    """n GBM-scale units: make_gbm_scale_setup's cohort topology at seeds
    0 .. n-1 (windowed, bf16 trunk, B = 32), each with its own model,
    context and batch."""
    return [make_gbm_scale_setup(topology="cohort", windowed=True, batch=32,
                                 compute_dtype="bfloat16", spmm_bf16=True, device="cuda",
                                 seed=s, topo_seed=s) for s in range(n)]


def fp_equal(name, stacked_fn, unit_fns):
    """The stacked launch's output equal to the concatenation of the units'
    own launches, bit for bit (each row is the same sum in the same
    order)."""
    out = stacked_fn()
    want = torch.cat([f() for f in unit_fns])
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError(f"{name}: stacked launch differs from per-unit launches "
                             f"by {float((out - want).abs().max())}")


def fp_plans_phase(units, gen):
    """Stacked K1 (residual, accumulating; all edges), K2 (forward and
    transpose sides) and K3 at U units and GBM width, bf16 and f32: each
    against its plain version (TOL_BF16 / TOL_F32; K3 equal) and against
    the concatenation of U per-unit launches (equal), with ms, the U
    launches' ms, bound, plain and library ms."""
    from multilevel_gnn_tpu_torch.core.graph import stack_graphs

    graphs = [u[2] for u in units]
    sg = stack_graphs(graphs)
    U, N = len(graphs), graphs[0].n_nodes
    E = sg.fields["senders"].shape[1]
    F = units[0][0].batch_size * units[0][0].node_embedding_dim
    ws = [spmm.edge_weights(g, "mean", g.edge_attr) for g in graphs]
    w = torch.cat([torch.cat([wu, wu.new_zeros(E - wu.shape[0])]) for wu in ws])
    plan = sg.view.winplan
    emit({"phase": "fold_parallel_plans", "units": U, "n_nodes": N, "edge_stride": E,
          "edges": [g.n_edges for g in graphs], "F": F,
          "stacked_rows": plan.num_nodes, "permuted_rows": int(plan.row_of.shape[0]),
          "k2_entries": plan.fwd.n_entries, "k2_blocks": plan.fwd.n_blocks,
          "residual_nnz": plan.res.nnz, "tres_nnz": plan.tres.nnz,
          "csr_nnz": sg.view.csr.nnz})
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(U * N, F, generator=gen, device="cuda").to(dt)
        xs = [x[u * N:(u + 1) * N] for u in range(U)]
        base = torch.randn(U * N, F, generator=gen, device="cuda")
        for case, stacked, per, acc in (
                ("stacked_residual", plan.res, [g.winplan.res for g in graphs], True),
                ("stacked_all_edges", sg.view.csr, [g.csr for g in graphs], False)):
            r = time_k1(case, stacked, x, w, acc, gen, reps=FP_SLOW_REPS)
            fp_equal(f"k1 {case} {dt}",
                     lambda: k1.segment_spmm_csr(x, w, stacked, base.clone() if acc else None),
                     [lambda u=u: k1.segment_spmm_csr(
                         xs[u], ws[u], per[u],
                         base[u * N:(u + 1) * N].clone() if acc else None) for u in range(U)])
            # the U launches' time: each into its own buffer, no copy timed
            bufs = [base[u * N:(u + 1) * N].clone() for u in range(U)] if acc else [None] * U
            r["per_unit_ms"] = device_ms(lambda: [k1.segment_spmm_csr(
                xs[u], ws[u], per[u], bufs[u]) for u in range(U)])
            emit({"phase": "fold_parallel_k1", **r})
            res[(case, r["dtype"])] = r
        for transpose in (False, True):
            case = "stacked_transpose" if transpose else "stacked_forward"
            r = time_k2(case, plan, x, w, transpose)
            units_k2 = [lambda u=u: k2.windowed_tile_spmm(xs[u], ws[u], graphs[u].winplan,
                                                          transpose) for u in range(U)]
            fp_equal(f"k2 {case} {dt}", lambda: k2.windowed_tile_spmm(x, w, plan, transpose),
                     units_k2)
            r["per_unit_ms"] = device_ms(lambda: [f() for f in units_k2])
            emit({"phase": "fold_parallel_k2", **r})
            res[(case, r["dtype"])] = r
        del x, xs, base
        msg = torch.randn(U * E, F, generator=gen, device="cuda").to(dt)
        r = time_k3(sg.view, msg, reps=FP_SLOW_REPS)
        r["case"] = "stacked_csr"
        units_k3 = [lambda u=u: k3.segment_max_csr(msg[u * E:(u + 1) * E], graphs[u].csr)
                    for u in range(U)]
        fp_equal(f"k3 {dt}", lambda: k3.segment_max_csr(msg, sg.view.csr), units_k3)
        r["per_unit_ms"] = device_ms(lambda: [f() for f in units_k3])
        emit({"phase": "fold_parallel_k3", **r})
        res[("stacked_csr", r["dtype"])] = r
        del msg
        torch.cuda.empty_cache()
    return res


def fp_state(units, cfg):
    """The units' stacked state for cfg (their models' parameters, an Adam
    over them with units=U, each unit's dropout generator seeded 1000 + u)
    and their stacked context, batch (raw_data too, where the units' carry
    it) and class weights."""
    from multilevel_gnn_tpu_torch.core.batch import Batch, stack_contexts
    from multilevel_gnn_tpu_torch.nn.basic import UnitGenerators
    from multilevel_gnn_tpu_torch.train.step import Optimizer, stack_params

    models = [u[1] for u in units]
    params = stack_params(models)
    st = dict(
        template=models[0], params=params, sctx=stack_contexts([u[3] for u in units]),
        opt=Optimizer(list(params.values()), cfg, 6, units=len(units)),
        gens=UnitGenerators(torch.Generator(device="cuda").manual_seed(1000 + i)
                            for i in range(len(units))),
        batch=Batch(**{f: None if getattr(units[0][4], f) is None else
                       torch.stack([getattr(u[4], f) for u in units])
                       for f in ("x", "y", "age", "sample_mask", "raw_data")}),
        cw=torch.tensor([[1.0, 1.5]] * len(units), device="cuda"))
    return st


def fp_step_phase(units, want=None, phase="fold_parallel_step", rounds=2,
                  tol=TOL_GRAD["bf16"], pathway=True):
    """One stacked train step at U units (the sage bf16 units by default)
    against the U units' own steps: per-unit gradients (the same dropout
    masks) within ``tol`` (relative to each parameter's largest gradient;
    TOL_GRAD's bf16 limit), launches ``want`` a stacked step (K1 7 / K2 4);
    CUDA-event ms, kernel ms, gap share and peak memory of a stacked step
    against a sequence of the U units' steps, each in turns (fp_compare,
    ``rounds``).  pathway: the model runs the pathway contraction, so each
    unit's own step launches PW (forward and backward), the stacked step
    none (its dense form under torch.vmap)."""
    from multilevel_gnn_tpu_torch.train.step import stacked_train_step

    cfg = units[0][0]
    st = fp_state(units, cfg)
    cw1 = st["cw"][0]
    # gradients: the units' own, then the stacked step's (its update off)
    rel = {}
    seq = [grads_of(u[1], u[4], u[3], cw1, seed=1000 + i)[1] for i, u in enumerate(units)]
    step = st["opt"].step
    st["opt"].step = lambda: None
    zero_launches()
    stacked_train_step(st["template"], st["params"], st["opt"], st["batch"], st["sctx"],
                       st["cw"], st["gens"])
    torch.cuda.synchronize()
    one = launch_counts()
    st["opt"].step = step
    for i, g in enumerate(seq):
        for n, ref in g.items():
            d = float((st["params"][n].grad[i] - ref).abs().max())
            rel[n] = max(rel.get(n, 0.0), d / max(float(ref.abs().max()), 1e-30))
    worst = max(rel.values())
    want = want or want_launches({k1.KERNEL.name: 7, k2.KERNEL.name: 4})

    def stacked():
        stacked_train_step(st["template"], st["params"], st["opt"], st["batch"],
                           st["sctx"], st["cw"], st["gens"])

    opts = [make_optimizer(u[1], cfg, 6) for u in units]
    gens = [torch.Generator(device="cuda").manual_seed(2000 + i) for i in range(len(units))]

    def sequential():
        for i, u in enumerate(units):
            train_step(u[1], opts[i], u[4], u[3], cw1, gens[i])

    own = {**want, **pw_launches(int(pathway), int(pathway))}
    out = fp_compare(stacked, sequential, want, len(units), rounds, own)
    ok = worst <= tol and one == want and out["ok"]
    emit({"phase": phase, "units": len(units), "launches_one_step": one,
          "grad_max_rel_err": worst, "tol": tol,
          "grad_rel_err_by_param": rel, **out, "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: gradients {worst}, launches {one}")
    return out["launches_stacked"]


def fp_compare(stacked, sequential, want, n_units, rounds=2, own=None):
    """CUDA-event ms (2 * rounds * (FP_STEPS // 4 + 1) calls of each,
    stacked and sequential in turns), kernel ms and gap share (profiler, 3
    calls) and peak memory of one stacked call against one sequence of the
    units' own calls; the stacked call's launches must equal ``want``, a
    unit's own call's ``own`` (``want`` where not given)."""
    own = want if own is None else own
    ms = {"stacked": [], "sequential": []}
    per = {}
    for _ in range(rounds):
        for name, fn in (("stacked", stacked), ("sequential", sequential),
                         ("sequential", sequential), ("stacked", stacked)):
            t, per[name] = timed_steps(fn, FP_STEPS // 4 + 1)
            ms[name] += t
    out = {}
    for name, fn in (("stacked", stacked), ("sequential", sequential)):
        busy, n_kernels, rows = profiled(fn, 3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        med = float(np.median(ms[name]))
        out[name] = {"ms_median": med, "ms": ms[name], "kernel_ms": busy,
                     "kernels": n_kernels, "gap_share": 1 - busy / med,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "peak_above_held_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
                     "port_kernel_ms": port_kernel_ms(rows), "top": top_rows(rows, 10)}
    return {"stacked": out["stacked"], "sequential": out["sequential"],
            "speedup": out["sequential"]["ms_median"] / out["stacked"]["ms_median"],
            "launches_stacked": per["stacked"], "launches_sequential": per["sequential"],
            "launches_expected": want,
            "ok": per["stacked"] == want and per["sequential"] == {
                k: v * n_units for k, v in own.items()}}


def fp_serve_phase(units):
    """One stacked eval batch at U units against the units' own eval_steps:
    probabilities per unit within TOL_FP_PROB (f32 trunk, then bf16),
    launches K1 2 / K2 2 a stacked batch, ms, gap share and peak memory
    against the sequence of U eval_steps."""
    from multilevel_gnn_tpu_torch.train.step import stacked_eval_step

    errs = {}
    for trunk in ("f32", "bf16"):
        us = units if trunk == "bf16" else [
            (u[0], MultilevelGNN(u[0].replace(compute_dtype=None, spmm_bf16=False),
                                 u[2].n_nodes, u[3].num_pca_rows, device="cuda", seed=s),
             u[2], u[3], u[4]) for s, u in enumerate(units)]
        st, errs[trunk], errs[trunk + "_loss"] = fp_eval_errs(us)
    # the loop ends on the bf16 trunk, whose stacked state is timed below
    want = want_launches({k1.KERNEL.name: 2, k2.KERNEL.name: 2})
    out = fp_compare(
        lambda: stacked_eval_step(st["template"], st["params"], st["batch"], st["sctx"]),
        lambda: [eval_step(u[1], u[4], u[3]) for u in units], want, len(units),
        own={**want, **pw_launches(1)})
    ok = (errs["bf16"] <= TOL_FP_PROB["bf16"] and errs["f32"] <= TOL_FP_PROB["f32"]
          and out["ok"])
    emit({"phase": "fold_parallel_serve", "units": len(units), "prob_max_abs_err": errs,
          "tol": TOL_FP_PROB, **out, "ok": ok})
    if not ok:
        raise AssertionError(f"fold_parallel_serve: {errs}, launches {out['launches_stacked']}")
    return out["launches_stacked"]


def fp_protocol_phase(root, small):
    """The train CLI with --fold-parallel on the reference-scale files (1 run
    x 5 folds x FP_PROTOCOL_EPOCHS epochs, gbm.yaml, bf16), counted, and
    the sequential CLI on the same files after it: wall times, pooled AUC /
    ACC; then a small
    protocol (f32, dropout off, 2 epochs) fold-parallel on the card, on the
    CPU and sequential on the card, pooled AUC / ACC within TOL_PROTOCOL."""
    from multilevel_gnn_tpu_torch.train import cli

    E = FP_PROTOCOL_EPOCHS
    args = ["--config", GBM_YAML, "--data-dir", root, "--set", "num_run=1", f"epochs={E}"]
    runs, launches = {}, {}
    for name, extra in (("fold_parallel", ["--fold-parallel"]), ("sequential", [])):
        sync("cuda")
        zero_launches()
        t0 = time.perf_counter()
        res = cli.main(args + extra)
        sync("cuda")
        runs[name] = (time.perf_counter() - t0, res)
        launches[name] = launch_counts()
    (w_fp, fp), (w_seq, seq) = runs["fold_parallel"], runs["sequential"]
    ok = bool(fp["units"] == 5 and launches["fold_parallel"][k1.KERNEL.name] > 0
              and launches["fold_parallel"][k3.KERNEL.name] == 0
              and 0.0 <= fp["auc"][E] <= 1.0)
    emit({"phase": "fold_parallel_protocol", "wall_s": {"fold_parallel": w_fp,
                                                        "sequential": w_seq},
          "cli_wall_time_s": {"fold_parallel": fp["wall_time_s"],
                              "sequential": seq["wall_time_s"]},
          "epoch_s_median": {"fold_parallel": fp["epoch_s_median"],
                             "sequential": seq["epoch_s_median"]},
          "fold_parallel_setup_s": fp["setup_s"], "fold_parallel_epoch_s": fp["epoch_s"],
          "sequential_fold_setup_s": [f["setup_s"] for f in seq["folds"]],
          "sequential_epoch_s": [f["epoch_s"] for f in seq["folds"]],
          "stacked_step_ms_median": fp["step_ms_median"],
          "unit_step_ms_median": [f["step_ms_median"] for f in seq["folds"]],
          "windowed": [f["windowed"] for f in seq["folds"]], "launches": launches,
          "epochs": E,
          "pooled_auc": {"fold_parallel": fp["auc"][E], "sequential": seq["auc"][E]},
          "pooled_acc": {"fold_parallel": fp["acc"][E], "sequential": seq["acc"][E]},
          "ok": ok})
    if not ok:
        raise AssertionError("fold_parallel_protocol failed")
    sets = ["num_run=1", "epochs=2", "compute_dtype=null", "spmm_bf16=false",
            "feature_drop=false", "head_drop_rate=0.0", "gnn_dropout=0.0"]
    small_runs = {}
    for name, dev, extra in (("fold_parallel_cuda", "cuda", ["--fold-parallel"]),
                             ("fold_parallel_cpu", "cpu", ["--fold-parallel"]),
                             ("sequential_cuda", "cuda", [])):
        small_runs[name] = cli.main(["--config", GBM_YAML, "--data-dir", small, "--device",
                                     dev, *extra, "--set", *sets])
    keys = ("auc", "auc_by_loss", "auc_by_epoch", "acc")
    ref = small_runs["fold_parallel_cuda"]
    diff = {n: max(abs(r[k][2] - ref[k][2]) for k in keys) for n, r in small_runs.items()}
    ok = max(diff.values()) <= TOL_PROTOCOL
    emit({"phase": "fold_parallel_protocol_small", "pooled_max_abs_diff": diff,
          "tol": TOL_PROTOCOL, "pooled_auc": {n: r["auc"][2] for n, r in small_runs.items()},
          "ok": ok})
    if not ok:
        raise AssertionError(f"fold_parallel small protocol: {diff}")
    return launches["fold_parallel"]


def fp_ckpt_phase(root, cohort):
    """Fold-parallel on the cohort files (gbm.yaml, bf16, 1 run x 5 folds x
    CKPT_EPOCHS epochs, ckpt_every 1) uninterrupted, and the same stopped
    after 2 epochs and resumed: pooled AUC / ACC equal; then the predict
    CLI scores fold 2 from the fold-parallel checkpoint, equal to
    predict_fold with that checkpoint loaded in memory."""
    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.train import predict
    from multilevel_gnn_tpu_torch.train.checkpoint import load_checkpoint
    from multilevel_gnn_tpu_torch.train.fold_parallel import run_experiment_foldparallel

    cfg = Config.from_yaml(GBM_YAML).replace(num_run=1, epochs=CKPT_EPOCHS, ckpt_every=1)
    a_dir, b_dir = f"{root}/fp_ckpt_a", f"{root}/fp_ckpt_b"
    t0 = time.perf_counter()
    a = run_experiment_foldparallel(cfg, cohort, ckpt_dir=a_dir)
    t_a = time.perf_counter() - t0
    run_experiment_foldparallel(cfg.replace(epochs=2), cohort, ckpt_dir=b_dir)
    t0 = time.perf_counter()
    b = run_experiment_foldparallel(cfg, cohort, ckpt_dir=b_dir, resume=True)
    t_b = time.perf_counter() - t0
    keys = ("auc", "acc", "auc_by_loss", "acc_by_loss", "auc_by_epoch", "acc_by_epoch")
    equal = all(a[k] == b[k] for k in keys)
    cli_res = predict.main(["--config", GBM_YAML, "--ckpt-dir", a_dir, "--fold", "2",
                            "--data-dir", root])
    st = predict.load_fold_state(Config.from_yaml(GBM_YAML), cohort, None, 0, 2)
    st["model"].load_state_dict(load_checkpoint(f"{a_dir}/run0_fold2")[0]["model"])
    mem = predict.predict_fold(Config.from_yaml(GBM_YAML), cohort, None, 0, 2,
                               model=st["model"])
    prob = np.asarray(cli_res["prob"])
    ok = bool(equal and cli_res["prob"] == mem["prob"] and len(prob) > 0
              and np.isfinite(prob).all() and 0.0 <= cli_res["auc"] <= 1.0)
    emit({"phase": "fold_parallel_ckpt", "epochs": CKPT_EPOCHS,
          "pooled_auc": [a["auc"][CKPT_EPOCHS], b["auc"][CKPT_EPOCHS]],
          "pooled_acc": [a["acc"][CKPT_EPOCHS], b["acc"][CKPT_EPOCHS]],
          "resumed_equal": equal, "uninterrupted_s": t_a, "resumed_s": t_b,
          "predict_auc": cli_res["auc"], "predict_patients": len(prob),
          "cli_equals_in_memory": cli_res["prob"] == mem["prob"], "ok": ok})
    if not ok:
        raise AssertionError("fold_parallel_ckpt: resume or predict failed")


# ---- fold-parallel CV of DeeperGCN, PathCNN and vae_finetune: the same
# stacked step, with each unit's raw side channel in its batch, DeeperGCN's
# edge-id lookup and DiffPool's pathway adjacency in the stacked context
FP_MEM_SPARE = 0.10  # share of the card's memory left free when U is chosen
# PathCNN's stacked step (f32): its convolutions one grouped convolution,
# its head batched GEMMs, summing in other orders than a unit's own
TOL_GRAD_FP_F32 = TOL_F32
# the small protocols of the families (f32, dropout off; PathCNN's and the
# DiffPool head's fixed dropouts off too), card against CPU
FP_FAMILIES = {
    "deepergcn_max": (*DGCN_SETS, "gcn_aggr=max"),
    "deepergcn_softmax": (*DGCN_SETS, "gcn_aggr=softmax"),
    "pathcnn_learnable": ("model=pathcnn", "learnable_pca=true"),
    "pathcnn_attrs": ("model=pathcnn", "learnable_pca=false"),
    "vae_finetune_conv_head": ("model=vae_finetune", "decoder_type=foreach"),
    "vae_finetune_diff_pooling": ("model=vae_finetune", "reorder_type=diff_pooling"),
}
FP_SMALL_SETS = ("num_run=1", "epochs=2", "compute_dtype=null", "spmm_bf16=false",
                 "feature_drop=false", "head_drop_rate=0.0", "gnn_dropout=0.0", "dropout=0.0")


def fpd_folds(cohort, n=FP_UNITS):
    """The DeeperGCN folds 0 .. n-1 of the protocol files (dgcn_cfg: B 32,
    H 128, 3 layers, bf16), each derived by fold_setup on the card:
    [(cfg, fold, X, (train, valid, test))]."""
    from multilevel_gnn_tpu_torch.train import driver

    cfg = dgcn_cfg()
    out = []
    for f in range(n):
        tr, va, te = driver.fold_indices(cohort.labels(), cfg, f)
        fcfg, fold, X = driver.fold_setup(cfg, cohort, tr, f, "cuda")
        out.append((fcfg.replace(pathway_num=cohort.n_pathways), fold, X, (tr, va, te)))
    return out


def fpd_kernel_phase(folds, gen):
    """The stacked DeeperGCN kernels at the folds' U and F = B * H = 4,096,
    where U * E * F passes 2^31 elements: K3 (bf16, f32; equal to plain),
    K1 as edge_segment_sum (over the stacked dst_gather) and as gather_src's
    backward (src_gather), bf16 and f32, and as the edge-id lookup's
    backward (f32, H: U rows of ~E entries each, a block a row; index_add_
    beside it); each against its plain version, bit-equal to the U units'
    own launches, with ms, the own launches' ms, bound, plain and library
    ms."""
    from multilevel_gnn_tpu_torch.core.batch import stack_contexts

    ctxs = [f[1].ctx for f in folds]
    sctx = stack_contexts(ctxs)
    g = sctx.graph.view
    U, E = len(ctxs), int(sctx.graph.fields["senders"].shape[1])
    B, H = folds[0][0].batch_size, folds[0][0].hidden_channels
    F = B * H
    lookup = sctx.view.edge_id_gather
    emit({"phase": "fold_parallel_deepergcn_plans", "units": U, "edge_stride": E,
          "edges": [c.graph.n_edges for c in ctxs], "F": F, "elements": U * E * F,
          "past_2_31": U * E * F >= 2 ** 31, "csr_nnz": g.csr.nnz,
          "lookup_rows": lookup.n_rows, **{f"lookup_{k}": v for k, v in
                                           k1_classes(lookup, False).items()}})
    res = {}

    def own(plans, x, w):
        return [lambda u=u: k1.segment_spmm_csr(x[u * E:(u + 1) * E], w[:E], plans[u])
                for u in range(U)]

    for dt in (torch.bfloat16, torch.float32):
        msg = torch.randn(U * E, F, generator=gen, device="cuda").to(dt)
        r = time_k3(g, msg, reps=FP_SLOW_REPS)
        r["case"] = "stacked_deepergcn_csr"
        units_k3 = [lambda u=u: k3.segment_max_csr(msg[u * E:(u + 1) * E], ctxs[u].graph.csr)
                    for u in range(U)]
        fp_equal(f"k3 deepergcn {dt}", lambda: k3.segment_max_csr(msg, g.csr), units_k3)
        r["per_unit_ms"] = device_ms(lambda: [f() for f in units_k3])
        emit({"phase": "fold_parallel_deepergcn_k3", **r})
        res[("stacked_deepergcn_csr", r["dtype"])] = r
        ones = torch.ones(U * E, device="cuda")
        for case, plan, attr in (("stacked_edge_segment_sum", g.dst_gather, "dst_gather"),
                                 ("stacked_gather_src_bwd", g.src_gather, "src_gather")):
            r = time_k1(case, plan, msg, ones, False, gen, reps=FP_SLOW_REPS)
            units_k1 = own([getattr(c.graph, attr) for c in ctxs], msg, ones)
            fp_equal(f"k1 {case} {dt}", lambda: k1.segment_spmm_csr(msg, ones, plan), units_k1)
            r["per_unit_ms"] = device_ms(lambda: [f() for f in units_k1])
            emit({"phase": "fold_parallel_deepergcn_k1", **r})
            res[(case, r["dtype"])] = r
        del msg
        torch.cuda.empty_cache()
    V = lookup.n_rows // U
    rows = (sctx.fields["edge_ids"] + V * torch.arange(U, device="cuda")[:, None]).reshape(-1)
    cot = torch.randn(U * E, H, generator=gen, device="cuda")
    ones = torch.ones(U * E, device="cuda")

    def index_add():
        return torch.zeros(lookup.n_rows, H, device="cuda").index_add_(0, rows, cot)

    r = time_k1("stacked_edge_id_lookup_bwd", lookup, cot, ones, False, gen, library=index_add)
    units_k1 = own([c.edge_id_gather for c in ctxs], cot, ones)
    fp_equal("k1 stacked_edge_id_lookup_bwd", lambda: k1.segment_spmm_csr(cot, ones, lookup),
             units_k1)
    r["per_unit_ms"] = device_ms(lambda: [f() for f in units_k1])
    emit({"phase": "fold_parallel_deepergcn_k1", **r, "rows": lookup.n_rows,
          "largest_row": int(torch.bincount(rows).max())})
    res[("stacked_edge_id_lookup_bwd", r["dtype"])] = r
    del sctx, cot, rows
    torch.cuda.empty_cache()
    return res


def fpd_units(folds, cohort, n):
    """The first n folds as fold-parallel units: (cfg, model, graph, ctx,
    batch), each model built as fold-parallel builds it (no
    apply_init_weight) from seed u, each batch the fold's first B train
    patients with its pathway node attrs."""
    from multilevel_gnn_tpu_torch.train import driver

    units = []
    for u, (fcfg, fold, X, (tr, _, _)) in enumerate(folds[:n]):
        model = driver._new_model(fcfg, fold.ctx, u, init_weight=False)
        units.append((fcfg, model, fold.ctx.graph, fold.ctx,
                      dgcn_batch(X, fold.raw, cohort, tr, fcfg.batch_size)))
    return units


def fpd_choose_units(folds, cohort):
    """U for the stacked DeeperGCN step: one unit's train step peak above
    the memory held before it, then the most units (at most FP_UNITS)
    whose steps fit the card with FP_MEM_SPARE of it to spare."""
    cfg, model, _, ctx, batch = fpd_units(folds, cohort, 1)[0]
    opt = make_optimizer(model, cfg, 6)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cw = torch.tensor([1.0, 1.5], device="cuda")
    train_step(model, opt, batch, ctx, cw, gen)  # the optimizer's state, allocated
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    train_step(model, opt, batch, ctx, cw, gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    total = torch.cuda.get_device_properties(0).total_memory
    fits = [u for u in range(1, FP_UNITS + 1) if held + u * peak <= (1 - FP_MEM_SPARE) * total]
    U = max(fits) if fits else 1
    why = (f"{U} steps of {peak / 1e9:.2f} GB above {held / 1e9:.2f} GB held fit "
           f"{1 - FP_MEM_SPARE:.0%} of {total / 1e9:.1f} GB"
           + ("" if U == FP_UNITS else f"; {U + 1} do not"))
    emit({"phase": "fold_parallel_deepergcn_units", "units": U, "unit_step_peak_gb": peak / 1e9,
          "held_gb": held / 1e9, "card_gb": total / 1e9, "spare": FP_MEM_SPARE, "why": why})
    del model, opt
    torch.cuda.empty_cache()
    return U


def fpd_phases(cohort, gen):
    """Every stacked DeeperGCN phase on the protocol files' five folds;
    returns (the kernel rows, serving launches a stacked batch, launches a
    stacked step)."""
    folds = fpd_folds(cohort)
    r = fpd_kernel_phase(folds, gen)
    serve, step = fpd_step_phases(folds, cohort)
    del folds
    torch.cuda.empty_cache()
    return r, serve, step


def fpd_step_phases(folds, cohort):
    """The stacked DeeperGCN step and eval batch at the U that fits the
    card; returns (launches a stacked batch, launches a stacked step)."""
    U = fpd_choose_units(folds, cohort)
    L = folds[0][0].num_layers
    units = fpd_units(folds, cohort, U)
    # a step: K3 once a layer; K1 as each layer's gather_src backward and once
    # as the edge-id lookup's backward; a batch: K3 once a layer
    step = fp_step_phase(units, want_launches({k1.KERNEL.name: L + 1, k3.KERNEL.name: L}),
                         "fold_parallel_deepergcn_step", rounds=1, pathway=False)
    serve = fp_serve_units(units, want_launches({k3.KERNEL.name: L}),
                           "fold_parallel_deepergcn_serve", rounds=1, pathway=False)
    del units
    torch.cuda.empty_cache()
    return serve, step


def fp_eval_errs(units):
    """(the units' stacked state, max |probability| and max |loss|
    difference of one stacked eval batch against the units' own
    eval_steps)."""
    from multilevel_gnn_tpu_torch.train.step import stacked_eval_step

    st = fp_state(units, units[0][0])
    pred, loss = stacked_eval_step(st["template"], st["params"], st["batch"], st["sctx"])
    ref = [eval_step(u[1], u[4], u[3]) for u in units]
    return (st, max(float((pred[i] - r[0]).abs().max()) for i, r in enumerate(ref)),
            max(abs(float(loss[i]) - float(r[1])) for i, r in enumerate(ref)))


def fp_serve_units(units, want, phase, rounds=2, pathway=True):
    """One stacked eval batch of the units against their own eval_steps:
    probabilities within TOL_FP_PROB of the units' trunk, launches ``want``
    a stacked batch; ms, gap share and peak memory against the sequence of
    U eval_steps (fp_compare); pathway: as fp_step_phase's, a PW forward
    in each unit's own eval_step."""
    from multilevel_gnn_tpu_torch.train.step import stacked_eval_step

    st, err, err_loss = fp_eval_errs(units)
    tol = TOL_FP_PROB["bf16" if units[0][0].compute_dtype else "f32"]
    out = fp_compare(
        lambda: stacked_eval_step(st["template"], st["params"], st["batch"], st["sctx"]),
        lambda: [eval_step(u[1], u[4], u[3]) for u in units], want, len(units), rounds,
        {**want, **pw_launches(int(pathway))})
    ok = err <= tol and out["ok"]
    emit({"phase": phase, "units": len(units), "prob_max_abs_err": err,
          "loss_max_abs_err": err_loss, "tol": tol, **out, "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: {err}, launches {out['launches_stacked']}")
    return out["launches_stacked"]


def fpf_vae_units(units, head):
    """The GBM units as vae_finetune units at gbm.yaml's widths (bf16
    trunk): the DiffPool head over a correlation + I adjacency of each
    unit's own (P x P), or the ConvHead on the foreach latent."""
    from multilevel_gnn_tpu_torch.models.vae import VAEClassifier

    kw = dict(reorder_type="diff_pooling") if head == "diff_pooling" else dict(
        decoder_type="foreach")
    out = []
    for s, (cfg, _, graph, ctx, batch) in enumerate(units):
        vcfg = cfg.replace(model="vae_finetune", **kw)
        P = vcfg.pathway_num
        corr = np.corrcoef(np.random.RandomState(6 + s).randn(P, 64)) + np.eye(P)
        vctx = dataclasses.replace(ctx, pathway_adj=torch.as_tensor(
            corr.astype(np.float32), device="cuda"))
        out.append((vcfg, VAEClassifier(vcfg, graph.n_nodes, ctx.num_pca_rows, device="cuda",
                                        seed=s), graph, vctx, batch))
    return out


def fpf_pathcnn_units(units):
    """The GBM units as PathCNN units (learnable PCA, f32), each batch with
    PCA-row values of its own (B, G)."""
    from multilevel_gnn_tpu_torch.models.pathcnn import PathCNN

    rng = np.random.RandomState(4)
    out = []
    for s, (cfg, _, graph, ctx, batch) in enumerate(units):
        pcfg = cfg.replace(model="pathcnn", learnable_pca=True, compute_dtype=None)
        raw = (rng.randn(cfg.batch_size, ctx.num_pca_rows) * 0.5).astype(np.float32)
        out.append((pcfg, PathCNN(pcfg, graph.n_nodes, ctx.num_pca_rows, device="cuda", seed=s),
                    graph, ctx, dataclasses.replace(batch, raw_data=torch.as_tensor(
                        raw, device="cuda"))))
    return out


def fpf_gbm_phases(units):
    """The stacked vae_finetune (DiffPool step and serving; ConvHead
    serving) and PathCNN (a step) on the GBM units; returns ({path:
    launches a stacked batch}, {path: launches a stacked step})."""
    sage_batch = want_launches({k1.KERNEL.name: 2, k2.KERNEL.name: 2})
    sage_step = want_launches({k1.KERNEL.name: 7, k2.KERNEL.name: 4})
    serve, per_step = {}, {}
    vae = fpf_vae_units(units, "diff_pooling")
    per_step["fold_parallel_vae_finetune_diff_pooling"] = fp_step_phase(
        vae, sage_step, "fold_parallel_vae_finetune_step", rounds=1)
    serve["fold_parallel_serve_vae_finetune_diff_pooling"] = fp_serve_units(
        vae, sage_batch, "fold_parallel_vae_finetune_serve", rounds=1)
    vae = fpf_vae_units(units, "conv_head")
    serve["fold_parallel_serve_vae_finetune_conv_head"] = fp_serve_units(
        vae, sage_batch, "fold_parallel_vae_finetune_conv_head_serve", rounds=1)
    del vae
    per_step["fold_parallel_pathcnn"] = fp_step_phase(
        fpf_pathcnn_units(units), want_launches(), "fold_parallel_pathcnn_step", rounds=1,
        tol=TOL_GRAD_FP_F32)
    torch.cuda.empty_cache()
    return serve, per_step


@contextlib.contextmanager
def dropout_off():
    """Every Dropout of the port passes its input through, PathCNN's and the
    DiffPool head's fixed rates too (config has no switch for them)."""
    from multilevel_gnn_tpu_torch.nn import basic

    fwd = basic.Dropout.forward
    basic.Dropout.forward = lambda self, x, generator=None: x
    try:
        yield
    finally:
        basic.Dropout.forward = fwd


def fpf_protocol_phase(small):
    """The train CLI's --fold-parallel for each family of FP_FAMILIES on the
    small files (f32, dropout off, 1 run x 5 folds x 2 epochs) on the card
    and on the CPU: pooled AUC / ACC within TOL_PROTOCOL, launches counted
    on the card; then DeeperGCN's fold-parallel with --ckpt-dir and
    ckpt_every 1, stopped after 2 of 3 epochs and resumed, equal to the
    uninterrupted run, and the predict CLI's fold 2 from its checkpoint
    equal to predict_fold with it loaded in memory."""
    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.train import cli, predict
    from multilevel_gnn_tpu_torch.train.checkpoint import load_checkpoint

    base = ["--config", GBM_YAML, "--data-dir", small, "--fold-parallel"]
    keys = ("auc", "auc_by_loss", "auc_by_epoch", "acc")
    launches = {}
    for name, sets in FP_FAMILIES.items():
        runs = {}
        with dropout_off():
            for dev in ("cuda", "cpu"):
                sync("cuda")
                zero_launches()
                runs[dev] = cli.main(base + ["--device", dev, "--set", *FP_SMALL_SETS, *sets])
                sync("cuda")
                if dev == "cuda":
                    launches[name] = launch_counts()
        diff = max(abs(runs["cuda"][k][2] - runs["cpu"][k][2]) for k in keys)
        got = launches[name]
        used = {k1.KERNEL.name: not name.startswith("pathcnn"),
                k3.KERNEL.name: name == "deepergcn_max"}
        ok = bool(diff <= TOL_PROTOCOL and runs["cuda"]["units"] == 5
                  and all((got[k] > 0) == v for k, v in used.items()))
        emit({"phase": "fold_parallel_families_protocol_small", "family": name,
              "pooled_max_abs_diff": diff, "tol": TOL_PROTOCOL,
              "pooled_auc": {d: r["auc"][2] for d, r in runs.items()},
              "pooled_acc": {d: r["acc"][2] for d, r in runs.items()},
              "wall_s": {d: r["wall_time_s"] for d, r in runs.items()},
              "launches_cuda": got, "ok": ok})
        if not ok:
            raise AssertionError(f"fold-parallel {name} small protocol: {diff}, launches {got}")
    sets = [*FP_SMALL_SETS, *FP_FAMILIES["deepergcn_max"]]
    a_dir, b_dir = f"{small}/fp_dgcn_a", f"{small}/fp_dgcn_b"
    run = base + ["--set", *sets, "ckpt_every=1"]
    a = cli.main(run + ["epochs=3", "--ckpt-dir", a_dir])
    cli.main(run + ["epochs=2", "--ckpt-dir", b_dir])
    b = cli.main(run + ["epochs=3", "--ckpt-dir", b_dir, "--resume"])
    equal = all(a[k] == b[k] for k in keys + ("acc_by_loss", "acc_by_epoch"))
    pargs = ["--config", GBM_YAML, "--data-dir", small, "--set", *sets, "epochs=3"]
    cli_res = predict.main(pargs + ["--ckpt-dir", a_dir, "--fold", "2"])
    cfg = Config.from_yaml(GBM_YAML, **cli.parse_overrides([*sets, "epochs=3"]))
    cohort = cli.make_cohort(cfg, False, small)
    st = predict.load_fold_state(cfg, cohort, None, 0, 2)
    st["model"].load_state_dict(load_checkpoint(f"{a_dir}/run0_fold2")[0]["model"])
    mem = predict.predict_fold(cfg, cohort, None, 0, 2, model=st["model"])
    prob = np.asarray(cli_res["prob"])
    ok = bool(equal and cli_res["prob"] == mem["prob"] and len(prob) > 0
              and np.isfinite(prob).all())
    emit({"phase": "fold_parallel_deepergcn_ckpt", "pooled_auc": [a["auc"][3], b["auc"][3]],
          "resumed_equal": equal, "predict_auc": cli_res["auc"],
          "predict_patients": len(prob), "cli_equals_in_memory": cli_res["prob"] == mem["prob"],
          "ok": ok})
    if not ok:
        raise AssertionError("fold-parallel deepergcn: resume or predict failed")
    return launches


def fold_parallel_phases(root, cohort, small, gen):
    """Every fold-parallel phase; returns (the kernel rows of
    fold_parallel_plans and of the stacked DeeperGCN, {path: launches},
    {path: launches a stacked step})."""
    units = fp_units()
    torch.cuda.synchronize()
    r = fp_plans_phase(units, gen)
    per_step = {"fold_parallel": fp_step_phase(units)}
    paths = {"fold_parallel_serve": fp_serve_phase(units)}
    serve, step = fpf_gbm_phases(units)
    paths.update(serve)
    per_step.update(step)
    del units
    torch.cuda.empty_cache()
    paths["fold_parallel_protocol"] = fp_protocol_phase(root, small)
    fp_ckpt_phase(root, cohort)
    r_dgcn, paths["fold_parallel_serve_deepergcn"], per_step["fold_parallel_deepergcn"] = (
        fpd_phases(cohort, gen))
    r.update(r_dgcn)
    for name, got in fpf_protocol_phase(small).items():
        paths[f"fold_parallel_protocol_{name}"] = got
    return r, paths, per_step


# ---- the ('data', 'model') mesh (parallel/).  NCCL refuses two ranks on
# one card, so on a one-card machine the script runs NCCL at world size 1
# (mesh_ws1) and puts two ranks on cuda:0 over gloo for the rest,
# each collective of card tensors staged through host memory
# (parallel/comm.py:_call); the kernels run on the card in both.
MESH_RANKS = 2
MESH_B, MESH_C = 32, 64  # the GBM fold's F = B*C = 2,048 at the SpMMs
MESH_DEADLINE_S = 400
# The halo mean divides each rank's f32 sum by the degree (halo.py:
# halo_gather_scatter, as JAX's), where the single-device mean rounds each
# weight w / deg to bf16: its bf16 reference is the single-device bf16 sum
# over the degree, held at TOL_BF16 (K2 rounds an entry's summed weights,
# K1 each weight, and the two paths send different edges through each);
# its input gradient comes back in bf16 in both, so one bf16 ulp of
# max|ref| (2^-7 of it) is the limit there.  In f32 the halo mean is held
# to the single-device mean at TOL_F32.
TOL_BF16_ULP = 2.0 ** -7
# A mesh step's gradients against the single-device step's, per parameter
# max|diff| / max|grad| (the worst): the single device runs the windowed
# SpMM (K2 over a permuted plan), the mesh its shard's composed K1 or the
# halo's per-rank plans.  The f32 trunk is held to TOL_GRAD's f32 limit
# (read 1.6e-6 on an H100, PERF.md).  In the bf16 trunk that change of
# route alone moves the single device's own gradients by 0.124
# (node_embedding; mesh_step's "order" witness: the single-device step on
# K1 composed against the windowed one; run twice, the step reads 0), and
# the mesh reads 0.115 (1 x 2 halo) and 0.124 (2 x 1); the limit is twice
# that.  The mesh's own share is held at TOL_GRAD: 2 x 1 against the
# single-device step on its own SpMM ("split", read 3.6e-3 in bf16).
TOL_MESH_GRAD = {"bf16": 0.25, "f32": TOL_GRAD["f32"]}


def _rel(got, ref):
    e, m = err_of(got.float(), ref.float())
    return e / max(1.0, m)


class MeshPerCall:
    """Inside this block every K1, K2 (with its residual K1) and K3 call
    that ops.spmm makes with its kernel on this rank is held against the
    plain version on the same inputs: K3 equal, K1 / K2 within TOL_F32
    (TOL_BF16 for bf16 rows) times max(1, max|ref|); ``worst`` the largest
    reading of each and ``calls`` their count."""

    def __enter__(self):
        self.real = (spmm._k1, spmm._k2, spmm._k3)
        self.worst = Counter()
        self.calls = Counter()
        real_k1, real_k2, real_k3 = self.real

        def wrap(real, name, plain_fn, exact=False):
            def pick(plain):
                fn = real(plain)
                if plain:
                    return fn

                def both(x, w_or_plan, *rest, **kw):
                    out = kw.get("out", rest[1] if len(rest) > 1 else None)
                    base = out.clone() if out is not None else None
                    got = fn(x, w_or_plan, *rest, **kw)
                    if base is not None:
                        ref = plain_fn(x, w_or_plan, rest[0], base)
                    else:
                        ref = plain_fn(x, w_or_plan, *rest, **kw)
                    tol = 0.0 if exact else (TOL_BF16 if x.dtype == torch.bfloat16
                                             else TOL_F32)
                    rel = _rel(got, ref)
                    self.calls[name] += 1
                    self.worst[name] = max(self.worst[name], rel)
                    if not rel <= tol:
                        raise AssertionError(
                            f"{name} call {self.calls[name]}: {rel} against plain > {tol}")
                    return got
                return both
            return pick

        spmm._k1 = wrap(real_k1, k1.KERNEL.name, k1.segment_spmm_csr_plain)
        spmm._k2 = wrap(real_k2, k2.KERNEL.name, k2.windowed_spmm_plain)
        spmm._k3 = wrap(real_k3, k3.KERNEL.name, k3.segment_max_csr_plain, exact=True)
        return self

    def __exit__(self, *exc):
        spmm._k1, spmm._k2, spmm._k3 = self.real
        return False

    def summary(self):
        return {"calls": dict(self.calls), "worst_rel_err": dict(self.worst)}


def mesh_ws1_rank(rank):
    """A spawned rank of an NCCL group of world size 1 on cuda:0: NCCL's
    collectives on card tensors, then the edge-partitioned sum, mean and
    max and the halo form (k = 1) of the GBM fold against single-device
    gather_scatter, counted."""
    import torch.distributed as dist

    from multilevel_gnn_tpu_torch.parallel import halo as PH
    from multilevel_gnn_tpu_torch.parallel import mesh as PM
    from multilevel_gnn_tpu_torch.parallel import scaling

    out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    t = torch.arange(4.0, device="cuda")
    dist.all_reduce(t)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    r = torch.empty_like(t)
    dist.all_to_all_single(r, t)
    g = [torch.empty_like(t)]
    dist.all_gather(g, t)
    out["collectives_ok"] = bool(torch.equal(r, t) and torch.equal(g[0], t)
                                 and torch.equal(t, torch.arange(4.0, device="cuda")))
    graph = scaling.gbm_graph("cuda")
    group = dist.group.WORLD
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(graph.n_nodes, MESH_B, MESH_C, generator=gen, device="cuda")
    shard = PM.edge_block(graph, 1, 0, group)
    hp = PH.build_halo_partition(PM.padded_graph(graph, 1), 1, windowed=True)
    halo = dataclasses.replace(shard, halo=hp.for_rank(0, group, "cuda", graph))
    errs, counts = {}, {}
    for name, g_, reduce in (("edge_sum", shard, "sum"), ("edge_mean", shard, "mean"),
                             ("edge_max", shard, "max"), ("halo_mean", halo, "mean"),
                             ("halo_sum", halo, "sum")):
        ref = spmm.gather_scatter(x, graph, reduce, graph.edge_attr)
        torch.cuda.synchronize()
        zero_launches()
        got = spmm.gather_scatter(x, g_, reduce, g_.edge_attr)
        torch.cuda.synchronize()
        counts[name] = launch_counts()
        errs[name] = _rel(got, ref)
        if reduce == "max" and not torch.equal(got, ref):
            raise AssertionError(f"mesh_ws1 {name}: K3 not equal to single device")
        if errs[name] > TOL_F32:
            raise AssertionError(f"mesh_ws1 {name}: {errs[name]} > {TOL_F32}")
    out.update(rel_err=errs, launches=counts)
    return out


def mesh_ws1_phase():
    from multilevel_gnn_tpu_torch.parallel.multihost import spawn

    t0 = time.perf_counter()
    r = spawn(mesh_ws1_rank, 1, backend="nccl", deadline_s=MESH_DEADLINE_S)[0]
    want = {"edge_sum": {k1.KERNEL.name: 1}, "edge_mean": {k1.KERNEL.name: 1},
            "edge_max": {k3.KERNEL.name: 1}}
    for name, w in want.items():
        for k, n in w.items():
            expect_launches(f"mesh_ws1 {name}", r["launches"][name][k], n)
    ok = r["collectives_ok"] and r["backend"] == "nccl" and all(
        r["launches"][n][k2.KERNEL.name] == 1 for n in ("halo_mean", "halo_sum"))
    emit({"phase": "mesh_ws1", **r, "wall_s": time.perf_counter() - t0,
          "tol": TOL_F32, "ok": ok})
    if not ok:
        raise AssertionError("mesh_ws1 failed")
    return r["launches"]


def _halo_predicted(rh):
    """K1 / K2 launches of one halo forward and backward on a rank: the
    interior K2 (and its residual K1 where there is one), the boundary K1;
    backward K2's transpose (with tres / res_csc K1), the boundary's csc
    K1 and the send gather's backward K1."""
    w = rh.win
    fwd1 = (1 if w.res.nnz else 0) + 1
    bwd1 = (1 if w.tres.nnz else 0) + (1 if w.res_csc.nnz else 0) + 2
    return want_launches({k1.KERNEL.name: fwd1 + bwd1, k2.KERNEL.name: 2})


def _mesh_halo(rank):
    """The halo mean aggregation of the GBM fold (bf16, windowed interiors)
    on a 1 x 2 mesh, forward and backward, against single device; every
    kernel call against its plain version; launches as predicted; each
    rank's kernels' device ms."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from multilevel_gnn_tpu_torch.parallel import comm
    from multilevel_gnn_tpu_torch.parallel import halo as PH
    from multilevel_gnn_tpu_torch.parallel import mesh as PM
    from multilevel_gnn_tpu_torch.parallel import scaling

    graph = scaling.gbm_graph("cuda")
    mesh = PM.make_mesh(1, MESH_RANKS)
    k = MESH_RANKS
    hp = PH.build_halo_partition(PM.padded_graph(graph, k), k, windowed=True)
    rh = hp.for_rank(rank, mesh.model_group, "cuda", graph)
    sg = dataclasses.replace(PM.edge_block(graph, k, rank, mesh.model_group), halo=rh)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(graph.n_nodes, MESH_B, MESH_C, generator=gen, device="cuda")
    t = torch.randn(graph.n_nodes, MESH_B, MESH_C, generator=gen, device="cuda")
    xr = x.clone().requires_grad_(True)
    deg = torch.clamp(graph.in_degree(), min=1.0)[:, None, None]
    ref = spmm.gather_scatter(xr, graph, "sum", graph.edge_attr, dtype=torch.bfloat16) / deg
    (ref * t).sum().backward()
    mean_ref = spmm.gather_scatter(x, graph, "mean", graph.edge_attr, dtype=torch.bfloat16)
    xm = x.clone().requires_grad_(True)

    def call(v):
        return spmm.gather_scatter(v, sg, "mean", sg.edge_attr, dtype=torch.bfloat16)

    torch.cuda.synchronize()
    zero_launches()
    with MeshPerCall() as pc:
        out = call(xm)
        (out * t).sum().div(k).backward()
    torch.cuda.synchronize()
    launches = launch_counts()
    dx = comm.all_reduce_(xm.grad.clone(), mesh.model_group)
    e_out, e_dx = _rel(out, ref), _rel(dx, xr.grad)
    e_mean = _rel(out, mean_ref)
    with torch.no_grad():
        e_f32 = _rel(spmm.gather_scatter(x, sg, "mean", sg.edge_attr),
                     spmm.gather_scatter(x, graph, "mean", graph.edge_attr))
    xt = x.clone().requires_grad_(True)

    def fwd_bwd():
        xt.grad = None
        (call(xt) * t).sum().backward()

    fwd_bwd()
    torch.cuda.synchronize()
    dist.barrier()
    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    ev[0].record()
    for _ in range(3):
        fwd_bwd()
    ev[1].record()
    ev[1].synchronize()
    step_ms = ev[0].elapsed_time(ev[1]) / 3
    dist.barrier()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fwd_bwd()
        torch.cuda.synchronize()
    rows = kernel_rows(prof, 3)
    syms = {name: sum(r[1] for r in rows if any(s in r[0] for s in SYMBOLS[name]))
            for name in (k1.KERNEL.name, k2.KERNEL.name)}
    H, Nl, F = hp.halo, hp.n_local, MESH_B * MESH_C
    return {
        "rank": rank, "H": H, "n_local": Nl, "interior": rh.n_interior,
        "boundary": rh.n_boundary, "launches": launches,
        "predicted": _halo_predicted(rh), "per_call": pc.summary(),
        "rel_err_out": e_out, "rel_err_dx": e_dx,
        "rel_err_out_vs_rounded_mean": e_mean, "rel_err_f32": e_f32,
        "fwd_bwd_event_ms": step_ms, "kernel_device_ms": syms,
        # the all_to_all per conv, in the SpMM's bf16, against the psum of
        # f32 (N_pad, F) partials a ring all-reduce would move
        "wire_bytes_all_to_all": k * (k - 1) * H * F * 2,
        "wire_bytes_all_gather": k * (k - 1) * Nl * F * 4,
        "psum_equiv_bytes": 2 * (k - 1) * k * Nl * F * 4,
    }


def _grad_errs(got, ref):
    """{parameter: max|diff| / max|grad|} of two {parameter: gradient}."""
    return {k: float((got[k] - ref[k]).abs().max()) / max(float(ref[k].abs().max()), 1e-30)
            for k in ref if k in got}


def _worst(errs):
    return max(errs.values())


def _mesh_step(rank):
    """One train step of the GBM sage model (windowed, B = 32, gbm.yaml's
    dropouts), bf16 and f32 trunks, on 1 x 2 with the halo and on 2 x 1:
    the loss and each parameter's gradient against the single-device
    step's; launches; ms a step (bf16).  Witnesses of the bf16 gap, each
    the worst parameter's max|diff| / max|grad|: the single-device step
    run twice (rerun); the single-device step on the 2 x 1 path's own
    SpMM, the window plan stripped and K1 composed over one rank's edge
    block (order); and 2 x 1 against that step (split)."""
    import torch.distributed as dist

    from multilevel_gnn_tpu_torch.parallel import mesh as PM
    from multilevel_gnn_tpu_torch.train import driver

    cfg, bf16_model, graph, ctx, batch = gbm_fold()
    tcfg, ctx = train_setup(cfg, ctx)
    f32_cfg = tcfg.replace(compute_dtype=None, spmm_bf16=False)
    f32_model = MultilevelGNN(f32_cfg, graph.n_nodes, ctx.num_pca_rows, device="cuda", seed=0)
    k1_ctx = PM.shard_ctx(ctx, PM.Mesh(1, 1, 0, 0))  # no group: the rank's SpMM alone
    cw = torch.tensor([1.0, 1.5], device="cuda")
    out = {}
    for trunk, model, mcfg0 in (("bf16", bf16_model, tcfg), ("f32", f32_model, f32_cfg)):
        init = {k: v.clone() for k, v in model.state_dict().items()}

        def step_of(c, mesh=None, mcfg=mcfg0):
            model.load_state_dict(init)
            opt = make_optimizer(model, mcfg, 1)
            loss = train_step(model, opt, batch, c, cw,
                              torch.Generator(device="cuda").manual_seed(3), mesh)
            return loss, {k: p.grad.clone() for k, p in model.named_parameters()
                          if p.grad is not None}

        ref_loss, ref = step_of(ctx)
        _, again = step_of(ctx)
        _, on_k1 = step_of(k1_ctx)
        out[f"{trunk}_witness"] = {"rerun": _worst(_grad_errs(again, ref)),
                                   "order": _worst(_grad_errs(on_k1, ref))}
        for name, (d, m, halo) in (("1x2_halo", (1, 2, True)), ("2x1", (2, 1, False))):
            mesh = PM.make_mesh(d, m)
            mcfg = mcfg0.replace(halo_exchange=halo)
            mctx = driver.mesh_ctx(mcfg, ctx, mesh)
            torch.cuda.synchronize()
            zero_launches()
            loss, grads = step_of(mctx, mesh, mcfg)
            torch.cuda.synchronize()
            launches = launch_counts()
            errs = _grad_errs(grads, ref)
            worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
            row = {"loss": float(loss), "ref_loss": float(ref_loss),
                   "grad_rel_err": worst[0][1], "worst_params": worst,
                   "median_param_err": float(np.median(list(errs.values()))),
                   "grad_dtypes": sorted({str(g.dtype) for g in grads.values()}),
                   "launches": launches, "ms_per_step": None}
            if name == "2x1":
                row["split"] = _worst(_grad_errs(grads, on_k1))
            if trunk == "bf16":
                model.load_state_dict(init)
                opt = make_optimizer(model, mcfg, 1)
                gen = torch.Generator(device="cuda").manual_seed(4)
                dist.barrier()
                row["ms_per_step"] = cuda_ms(
                    lambda: train_step(model, opt, batch, mctx, cw, gen, mesh),
                    iters=3, warmup=1)
            out[f"{trunk}_{name}"] = row
        model.load_state_dict(init)
    return out


def _mesh_protocol(rank):
    """The small protocol (SMALL_COHORT, f32, dropout off, 2 epochs) on 2 x 1
    and on 1 x 2 with the halo: every fold's test scores and the pooled
    metrics."""
    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.data.synthetic import make_synthetic_cohort
    from multilevel_gnn_tpu_torch.train import driver

    cfg = Config.from_yaml(GBM_YAML).replace(
        num_run=1, epochs=2, compute_dtype=None, spmm_bf16=False, feature_drop=False,
        head_drop_rate=0.0, gnn_dropout=0.0)
    out = {}
    for name, (d, m, halo) in (("2x1", (2, 1, False)), ("1x2_halo", (1, 2, True))):
        cohort = make_synthetic_cohort(cfg, **SMALL_COHORT)
        rec, undo = _spy_folds()
        zero_launches()
        t0 = time.perf_counter()
        try:
            res = driver.run_experiment(
                cfg.replace(mesh_data_axis=d, mesh_model_axis=m, halo_exchange=halo),
                cohort, device="cuda")
        finally:
            undo()
        out[name] = {"wall_s": time.perf_counter() - t0, "launches": launch_counts(),
                     "auc": res["auc"][2], "acc": res["acc"][2],
                     "epoch_pred": [r.epoch_pred[2] for r in rec],
                     "epoch_pred_by_epoch": [r.epoch_pred_by_epoch[2] for r in rec]}
    return out


def mesh_group_rank(rank):
    """A rank of the two-rank gloo group on cuda:0: mesh_halo, mesh_step
    and mesh_protocol's parts, with their seconds."""
    out = {}
    for name, fn in (("halo", _mesh_halo), ("step", _mesh_step),
                     ("protocol", _mesh_protocol)):
        t0 = time.perf_counter()
        out[name] = fn(rank)
        out[name]["rank_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


SMALL_SCORES = {}  # experiment_phase's small protocol: (fold results, result) by device


def mesh_phases(gen):
    """mesh_halo, mesh_step and mesh_protocol on two gloo ranks of cuda:0;
    returns ({path: launches}, the per-rank kernel forms)."""
    from multilevel_gnn_tpu_torch.parallel.multihost import spawn

    t0 = time.perf_counter()
    ranks = spawn(mesh_group_rank, MESH_RANKS, backend="gloo", deadline_s=MESH_DEADLINE_S)
    spawn_s = time.perf_counter() - t0
    paths = {}
    halo = [r["halo"] for r in ranks]
    ok = True
    for h in halo:
        ok &= h["launches"] == h["predicted"]
        ok &= h["rel_err_out"] <= TOL_BF16 and h["rel_err_dx"] <= TOL_BF16_ULP
        ok &= h["rel_err_f32"] <= TOL_F32
        paths[f"mesh_halo_rank{h['rank']}"] = h["launches"]
    emit({"phase": "mesh_halo", "backend": "gloo", "ranks_per_card": MESH_RANKS,
          "ranks": halo, "tol_out": TOL_BF16, "tol_dx": TOL_BF16_ULP, "tol_f32": TOL_F32,
          "ok": bool(ok)})
    if not ok:
        raise AssertionError("mesh_halo failed")
    step = [r["step"] for r in ranks]
    ok = True
    for i, s in enumerate(step):
        for trunk in TOL_MESH_GRAD:
            for name in ("1x2_halo", "2x1"):
                c = s[f"{trunk}_{name}"]
                ok &= abs(c["loss"] - c["ref_loss"]) <= 1e-4 * abs(c["ref_loss"])
                ok &= c["grad_rel_err"] <= TOL_MESH_GRAD[trunk]
                ok &= c["grad_dtypes"] == ["torch.float32"]
                ok &= c["launches"][k1.KERNEL.name] > 0
            ok &= s[f"{trunk}_2x1"]["split"] <= TOL_GRAD[trunk]
        for name in ("1x2_halo", "2x1"):
            paths[f"mesh_step_{name}_rank{i}"] = s[f"bf16_{name}"]["launches"]
        ok &= s["bf16_1x2_halo"]["launches"][k2.KERNEL.name] > 0
    emit({"phase": "mesh_step", "backend": "gloo", "ranks_per_card": MESH_RANKS,
          "note": "the two ranks share one card: ms per step is each rank's, both running",
          "ranks": step, "tol": TOL_MESH_GRAD, "tol_loss_rel": 1e-4, "ok": bool(ok)})
    step_ok = ok
    prot = [r["protocol"] for r in ranks]
    errs, ok = {}, True
    for dev in ("cuda", "cpu"):
        rec, res = SMALL_SCORES[dev]
        for name in ("2x1", "1x2_halo"):
            got = prot[0][name]
            e = max(max(float(np.abs(a - b.epoch_pred[2]).max()),
                        float(np.abs(c - b.epoch_pred_by_epoch[2]).max()))
                    for a, c, b in zip(got["epoch_pred"], got["epoch_pred_by_epoch"], rec))
            errs[f"{name}_vs_{dev}"] = e
            ok &= len(got["epoch_pred"]) == 5 and e <= TOL_PROTOCOL
    for i, p in enumerate(prot):
        for name in ("2x1", "1x2_halo"):
            paths[f"mesh_protocol_{name}_rank{i}"] = p[name]["launches"]
            ok &= p[name]["auc"] == prot[0][name]["auc"]
    emit({"phase": "mesh_protocol", "backend": "gloo", "ranks_per_card": MESH_RANKS,
          "fold_max_abs_err": errs, "tol": TOL_PROTOCOL,
          "pooled": {n: {"auc": prot[0][n]["auc"], "acc": prot[0][n]["acc"],
                         "wall_s": prot[0][n]["wall_s"]} for n in ("2x1", "1x2_halo")},
          "rank_s": [{k: r[k]["rank_s"] for k in ("halo", "step", "protocol")}
                     for r in ranks],
          "spawn_wall_s": spawn_s, "ok": bool(ok)})
    if not (ok and step_ok):
        raise AssertionError("mesh_step or mesh_protocol failed")
    return paths, mesh_forms(gen)


def mesh_forms(gen):
    """The per-rank kernel forms at rank 0's plans of the GBM fold on two
    ranks (timed in this process, alone on the card): the halo's interior
    K2 (forward and transpose), boundary K1 (by receiver; backward by halo
    slot), the send gather's backward K1, and the edge shard's K1 (csr) and
    K3, bf16, F = 2,048."""
    from multilevel_gnn_tpu_torch.parallel import halo as PH
    from multilevel_gnn_tpu_torch.parallel import mesh as PM
    from multilevel_gnn_tpu_torch.parallel import scaling

    graph = scaling.gbm_graph("cuda")
    k, F, bf = MESH_RANKS, MESH_B * MESH_C, torch.bfloat16
    hp = PH.build_halo_partition(PM.padded_graph(graph, k), k, windowed=True)
    rh = hp.for_rank(0, None, "cuda", graph)
    sg = PM.edge_block(graph, k, 0)
    w = rh.edge_attr
    Nl, KH = hp.n_local, hp.k * hp.halo

    def rows(n):
        return torch.randn(n, F, generator=gen, device="cuda").to(bf)

    res = {
        "halo_interior_rank0": ("k2", time_k2("halo_interior_rank0", rh.win, rows(Nl), w, False)),
        "halo_interior_t_rank0": ("k2", time_k2("halo_interior_t_rank0", rh.win, rows(Nl), w,
                                                True)),
        "halo_boundary_rank0": ("k1", time_k1("halo_boundary_rank0", rh.bnd_csr, rows(KH), w,
                                              False, gen)),
        "halo_boundary_bwd_rank0": ("k1", time_k1("halo_boundary_bwd_rank0", rh.bnd_csc,
                                                  rows(Nl), w, False, gen)),
        "halo_send_gather_bwd_rank0": ("k1", time_k1(
            "halo_send_gather_bwd_rank0", rh.send_plan, rows(KH),
            torch.ones(KH, device="cuda"), False, gen)),
        "edge_shard_csr_rank0": ("k1", time_k1(
            "edge_shard_csr_rank0", sg.csr, rows(graph.n_nodes),
            spmm.edge_weights(sg, "mean", sg.edge_attr), False, gen)),
    }
    msg = rows(sg.num_padded_edges)
    r3 = time_k3(sg, msg)
    r3["case"] = "edge_shard_csr_rank0 " + r3["case"]
    res["edge_shard_k3_rank0"] = ("k3", r3)
    for name, (kind, r) in res.items():
        emit({"phase": "mesh_forms", "kernel": kind, **r, "H": hp.halo, "n_local": Nl})
    return res


def bench_scaling_phase(line, process_s):
    """The train CLI's --bench-scaling on the card (warm_phase runs it): the
    anchor only on one card (K2 + K1, forward and backward, B = 2,
    C = 64); JAX's keys and the CLI's builds."""
    keys = {"metric", "value", "unit", "backend", "n_devices", "E", "B", "C", "sizes", "ms",
            "edges_per_s_per_chip", "efficiency", "wire_bytes_per_conv",
            "psum_equiv_bytes", "halo_H", "builds"}
    n = torch.cuda.device_count()
    ok = (set(line) == keys and line["backend"] == "cuda" and line["n_devices"] == n
          and (line["sizes"] == [1] if n == 1 else line["sizes"][0] == 1)
          and all(np.isfinite(v) and v > 0 for v in line["ms"].values()))
    emit({"phase": "bench_scaling", **line, "process_s": process_s, "ok": ok})
    if not ok:
        raise AssertionError("bench_scaling failed")


# ---- kirc.yaml and lgg.yaml, the shipped configs of the other two cohorts,
# on the GBM fold: B = 64, pca_dim 3, head_dim 512, the pathway reorder
# (kirc: pools 1 x 1, no age; lgg: pools 4 x 2, the age concat).  Their
# first SAGE layer aggregates at F = B * node_embedding_dim = 2,048 (the
# Config's default 32, which neither file sets), the GBM fold's width; the
# second at F = B * hidden = 4,096.
SHIPPED = ("kirc", "lgg")
SHIPPED_REORDER_SEED = 16  # the fold's pathway reorder, a seeded permutation


def shipped_yaml(name):
    return str(REPO / "configs" / f"{name}.yaml")


def shipped_kernels(graph, ctx, gen):
    """K2 and K1 at the second SAGE layer's width under kirc.yaml and
    lgg.yaml (F = B * hidden, 4,096), bf16 and f32, each against its plain version
    and bit-equal over two calls, with ms, bound, plain and library ms:
    K2's forward and transpose; K1 over the residual, tres and res_csc
    (accumulating, the windowed route) and over all edges, csr and csc
    (the composed route); and K1 as the gather_rows backward at F = B *
    final (2,048)."""
    from multilevel_gnn_tpu_torch.core.config import Config

    # both files give the trunk the same widths
    (B, hidden, final), = {(c.batch_size, c.hidden_channels, c.final_channels)
                           for c in map(Config.from_yaml, map(shipped_yaml, SHIPPED))}
    plan = graph.winplan
    w = spmm.edge_weights(graph, "mean", graph.edge_attr)
    F, F_gather = B * hidden, B * final
    ones = torch.ones(ctx.num_pca_rows, device="cuda")
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        d = str(dt).split(".")[-1]
        x = torch.randn(graph.n_nodes, F, generator=gen, device="cuda").to(dt)
        for case, transpose in (("forward", False), ("transpose", True)):
            out[(case, d)] = time_k2(f"{case} F={F}", plan, x, w, transpose)
            emit({"phase": "shipped_k2", **out[(case, d)]})
        for case, p, acc in (("residual", plan.res, True), ("tres", plan.tres, True),
                             ("res_csc", plan.res_csc, True), ("csr", graph.csr, False),
                             ("csc", graph.csc, False)):
            out[(case, d)] = time_k1(f"{case} F={F}", p, x, w, acc, gen)
            emit({"phase": "shipped_k1", **out[(case, d)]})
        del x
        g = torch.randn(ctx.num_pca_rows, F_gather, generator=gen, device="cuda").to(dt)
        dst = torch.zeros(graph.n_nodes, F_gather, device="cuda", dtype=dt)
        out[("gather_rows_bwd", d)] = time_k1(
            f"gather_rows_bwd F={F_gather}", ctx.pca_gather, g, ones, False, gen,
            library=lambda: dst.zero_().index_add_(0, ctx.pca_rows, g))
        emit({"phase": "shipped_k1", **out[("gather_rows_bwd", d)]})
        del g, dst
    return out


def shipped_fold(name, graph, ctx):
    """(cfg, model, ctx): configs/<name>.yaml with only node_num and
    pathway_num set to the fold's, its bf16 trunk with spmm_bf16 and B =
    64 as shipped, seeded random weights; the fold's ctx with a seeded
    non-identity reorder of its pathways."""
    from multilevel_gnn_tpu_torch.core.config import Config

    n_pathways = int(ctx.reorder_idxs.numel())
    cfg = Config.from_yaml(shipped_yaml(name)).replace(
        node_num=graph.n_nodes // 3, pathway_num=n_pathways)
    perm = np.random.RandomState(SHIPPED_REORDER_SEED).permutation(n_pathways)
    ctx = dataclasses.replace(ctx, reorder_idxs=torch.as_tensor(perm, device="cuda"))
    model = MultilevelGNN(cfg, graph.n_nodes, ctx.num_pca_rows, device="cuda", seed=0)
    return cfg, model, ctx


def per_call(phase, fn, want):
    """fn() with every K1 / K2 call held against its plain version on its
    own inputs (PerCall); the calls as the code predicts."""
    with PerCall() as pc:
        out = fn()
    torch.cuda.synchronize()
    s = pc.summary()
    ok = s["calls"] == want
    emit({"phase": phase, **s, "calls_expected": want, "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: kernel calls {s['calls']}, want {want}")
    return out


def shipped_phases(name, graph, ctx):
    """configs/<name>.yaml's serving and training on the GBM fold:

    - serve_<name>: predict_patients over the 123 patients (two batches of
      64, the last one padded), counted: K1 2 / K2 2 a batch;
    - slice_<name>: the eval forward with kernels against plain versions
      (bf16 and f32 trunks; probabilities and the pathway image), and
      every kernel call of the bf16 forward against its plain version
      (per_call_eval_<name>);
    - profile_<name>: device ms by kernel of one full eval batch, gap share;
    - train_grad_<name>: one train step's gradients, kernels against plain
      versions (TOL_GRAD), the same parameters without a gradient on both
      sides; two calls' gradients equal bit for bit, and every kernel call
      of the step against its plain version (per_call_step_<name>);
    - profile_train_<name>: K1 7 / K2 4 a step from the counters over the
      timed steps, kernel ms, gap share and peak memory.

    Returns (launches a serving batch, launches a train step)."""
    cfg, model, ctx = shipped_fold(name, graph, ctx)
    B = cfg.batch_size
    per_batch, per_step = conv_launches("sage", graph.winplan)
    emit({"phase": f"{name}_setup", "config": Path(shipped_yaml(name)).name, "batch": B,
          "pca_dim": cfg.pca_dim, "head_dim": cfg.head_dim,
          "pools": [cfg.pathway_pool_dim, cfg.pca_pool_dim], "use_age": cfg.use_age,
          "reorder_pathway": cfg.reorder_pathway,
          "selected_similarity": cfg.selected_similarity, "lr": cfg.lr, "step": cfg.step,
          "spmm_F": [B * cfg.node_embedding_dim, B * cfg.hidden_channels],
          "compute_dtype": cfg.compute_dtype, "spmm_bf16": cfg.spmm_bf16,
          "params": sum(p.numel() for p in model.parameters())})
    if not cfg.reorder_pathway or bool((ctx.reorder_idxs == torch.arange(
            len(ctx.reorder_idxs), device="cuda")).all()):
        raise AssertionError(f"{name}: no pathway reorder on the fold")

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
    n_batches = -(-N_PATIENTS // B)
    prob = np.asarray(res["prob"])
    want = {k: v * n_batches for k, v in per_batch.items()}
    ok = (len(prob) == N_PATIENTS and bool(np.isfinite(prob).all())
          and bool(((prob >= 0) & (prob <= 1)).all()) and np.isfinite(res["loss"])
          and launches == want)
    emit({"phase": f"serve_{name}", "batches": n_batches, "patients": N_PATIENTS,
          "ms_per_batch": dt * 1e3 / n_batches, "launches": launches,
          "launches_expected": want, "auc": res["auc"], "acc": res["acc"],
          "loss": res["loss"], "ok": ok})
    if not ok:
        raise AssertionError(f"serve_{name} failed")

    batch = next(iter_batches(X, Y, ages, idx, B, "cuda"))
    f32 = cfg.replace(compute_dtype=None, spmm_bf16=False)
    forward_vs_plain(f"slice_{name}", (
        ("bf16", TOL_IMAGE_BF16, lambda: model),
        ("f32", TOL_IMAGE_F32, lambda: MultilevelGNN(
            f32, graph.n_nodes, ctx.num_pca_rows, device="cuda", seed=0)),
    ), ctx, batch)
    model.eval()
    with torch.no_grad():
        per_call(f"per_call_eval_{name}", lambda: model(batch, ctx),
                 {k1.KERNEL.name: per_batch[k1.KERNEL.name],
                  k2.KERNEL.name: per_batch[k2.KERNEL.name]})
    profile_eval(model, ctx, batch, f"profile_{name}")

    tcfg, tctx = train_setup(cfg, ctx)
    Xt, Yt, at = patients(graph.n_nodes, n=N_TRAIN_PATIENTS, seed=2)
    tr = np.arange(192)
    cw = torch.as_tensor(class_weight(Yt, tr, tcfg.weight_power), dtype=torch.float32,
                         device="cuda")
    tbatch = next(iter_batches(Xt, Yt, at, tr, B, "cuda"))
    train_grad_checks((("bf16", model),), tctx, tbatch, cw, phase=f"train_grad_{name}")
    _, g1, _ = grads_of(model, tbatch, tctx, cw, seed=5)
    _, g2, _ = per_call(f"per_call_step_{name}",
                        lambda: grads_of(model, tbatch, tctx, cw, seed=5),
                        {k1.KERNEL.name: per_step[k1.KERNEL.name],
                         k2.KERNEL.name: per_step[k2.KERNEL.name]})
    _, g3, _ = grads_of(model, tbatch, tctx, cw, seed=5)
    differ = sorted(n for n in g1 if not (torch.equal(g1[n], g2[n])
                                           and torch.equal(g1[n], g3[n])))
    emit({"phase": f"train_grad_repeat_{name}", "params": len(g1), "differ": differ,
          "ok": not differ})
    if differ:
        raise AssertionError(f"{name}: gradients of two calls differ in {differ}")
    del g1, g2, g3
    model.zero_grad(set_to_none=True)
    got, _ = profile_train(model, tctx, tbatch, cw, per_step,
                           phase=f"profile_train_{name}")
    del model
    torch.cuda.empty_cache()
    return launches, got


def shipped_experiment_phase(name, root):
    """The train CLI under configs/<name>.yaml on the reference-scale files
    (experiment_phase), root/<name> linked to cohort_phase's root/gbm
    (write_reference_format(root, cancer_type=name, **REF_COHORT) would
    write the same bytes: the cancer type only names the directory), with
    each fold's pathway reorder traced: under selected_similarity (kirc)
    each fold derives its own from the fold's pathway matrix; otherwise
    (lgg) every fold keeps the cohort's initial one.  Then the small
    protocol (f32, dropout off) on the card and on the CPU under the same
    config."""
    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.data.cohort import Cohort

    real_fold, real_matrix = Cohort.fold, Cohort._reorder_from_matrix
    derived, folds = [], []

    def from_matrix(self, pathway_matrix):
        derived.append(real_matrix(self, pathway_matrix))
        return derived[-1]

    def fold(self, *a, **k):
        before = len(derived)
        fd = real_fold(self, *a, **k)
        own = derived[before:]
        folds.append(dict(
            derived=len(own),
            equals_derived=bool(own) and np.array_equal(fd.reorder_idxs, own[-1]),
            equals_initial=self.initial_reorder_idxs is not None
            and np.array_equal(fd.reorder_idxs, self.initial_reorder_idxs),
            identity=bool(np.array_equal(fd.reorder_idxs,
                                         np.arange(len(fd.reorder_idxs))))))
        return fd

    def traced():
        selected = Config.from_yaml(shipped_yaml(name)).selected_similarity
        ok = len(folds) == 5 and all(
            (f["derived"] == 1 and f["equals_derived"]) if selected
            else (f["derived"] == 0 and f["equals_initial"]) for f in folds)
        return {"fold_reorder": folds, "reorder_from_selected_similarity": selected}, ok

    os.symlink(os.path.join(root, "gbm"), os.path.join(root, name))
    Cohort.fold, Cohort._reorder_from_matrix = fold, from_matrix
    try:
        launches = experiment_phase(root, yaml=shipped_yaml(name), phase=f"experiment_{name}",
                                    extra=traced)
    finally:
        Cohort.fold, Cohort._reorder_from_matrix = real_fold, real_matrix
    small_protocol_vs_cpu(shipped_yaml(name), f"experiment_{name}_small_vs_cpu")
    return launches


def card_setup() -> str:
    """The card's nvidia-smi name and power limit.  TF32 stays as torch
    leaves it (cuBLAS off, cuDNN on): the port's f32 convolutions turn it
    off themselves, and every phase holds that default path."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def build_phase() -> dict:
    """Every kernel built from the checkout's sources, in parallel, and the
    data libraries (g++) beside them; returns {kernel: build seconds}."""
    from concurrent.futures import ThreadPoolExecutor

    from multilevel_gnn_tpu_torch.data import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        libraries = pool.submit(native.build_libraries)
        times = build.build_all()
        library_s = libraries.result()
    regs = {
        k.name: [ln.strip() for ln in k.ptxas_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        for k in build.REGISTRY.values()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": times, "data_libraries_s": library_s, "ptxas": regs})
    return times


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
    with contextlib.ExitStack() as stack:
        return run(stack)


def run(stack) -> int:
    """The phases in order; stack ends the run's child process and removes
    its files when the run ends."""
    smi = card_setup()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_tf32": torch.backends.cudnn.allow_tf32})

    build_s = build_phase()
    # the protocol's files, written beside the card's phases
    root = stack.enter_context(tempfile.TemporaryDirectory())
    writer = start_cohort_files(root)
    stack.callback(writer.kill)  # a no-op once cohort_phase has waited for it

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
    # ---- P1, the row-gather probe (tools/bench_dma_gather.py): its own path
    p1_path, r_p1, r_p1_readings = dma_gather_phase(
        {d: r1[("all_edges", d)]["ms"] for d in ("bfloat16", "float32")},
        build_s[p1.KERNEL.name], graph, p1.dma_row_gather_ordered)
    pathway_phase()

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
    # the sage and GAT artifacts, loaded in one fresh process after both are saved
    export_root = tempfile.TemporaryDirectory()
    exports = [export_save(model, ctx, batch, export_root.name)]

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
                  want_launches({k1.KERNEL.name: 5, **pw_launches(1, 1)}),
                  phase="profile_train_composed")
    del tr
    torch.cuda.empty_cache()
    repairs_phase(model, ctx, train_kernel_ms)
    paths = {"dma_gather": p1_path, "serve_sage": launches,
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
    exports.append(export_save(gat, ctx, batch, export_root.name, "export_gat",
                               conv_launches("gat", graph.winplan)[0]))
    del gat
    paths["export"], paths["export_gat"] = export_check(exports)
    export_root.cleanup()
    del exports
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
    del model, batch
    torch.cuda.empty_cache()

    # ---- kirc.yaml and lgg.yaml on the same fold (B = 64)
    r_shipped = shipped_kernels(graph, ctx, gen)
    for name in SHIPPED:
        paths[f"serve_{name}"], per_step[name] = shipped_phases(name, graph, ctx)
    del ctx
    torch.cuda.empty_cache()

    # ---- the protocol from reference-format files
    cohort = cohort_phase(root, writer=writer)
    paths["experiment"] = experiment_phase(root)
    SMALL_SCORES.update(small_protocol_vs_cpu(GBM_YAML, "experiment_small_vs_cpu"))
    for name in SHIPPED:
        paths[f"experiment_{name}"] = shipped_experiment_phase(name, root)
    small = small_files(root)
    profile_phase(small)
    ckpt_dir = ckpt_phase(root, cohort)
    paths["predict"] = predict_phase(root, cohort, ckpt_dir)
    paths["explain_cli"] = explain_cli_phase(root, ckpt_dir)
    # ---- fold-parallel CV: the units in one stacked step
    r_fp, fp_paths, fp_step = fold_parallel_phases(root, cohort, small, gen)
    paths.update(fp_paths)
    per_step.update(fp_step)
    # ---- DeeperGCN on the same files' gene-level fold graph
    dg = deepergcn_phases(root, cohort, gen)
    paths["serve_deepergcn"] = dg["serve"]
    paths["experiment_deepergcn"] = dg["experiment"]
    paths["explain_deepergcn"] = dg["explain"]
    per_step["deepergcn"] = dg["per_step"]
    paths.update(dg["s11"]["serve"])
    per_step.update(dg["s11"]["per_step"])
    del cohort
    # ---- STRING PPI tables beside the GRN list: edge_type ppi and merge
    from multilevel_gnn_tpu_torch.data.loaders import read_kegg_csv
    from multilevel_gnn_tpu_torch.data.synthetic import write_string_ppi

    write_string_ppi(root, read_kegg_csv(f"{root}/kegg.csv"), seed=3, e_ppi=PPI_EDGES,
                     cancer_type="gbm")
    write_string_ppi(small, read_kegg_csv(f"{small}/kegg.csv"), seed=3, e_ppi=800,
                     cancer_type="gbm")
    for edge_type in ("ppi", "merge"):
        paths[edge_type] = graph_source_phase(edge_type, root, small)
        torch.cuda.empty_cache()
    paths["gat_protocol"] = gat_protocol_phase(small)
    paths["pretrain_protocol"], paths["pathcnn_protocol"] = pretrain_protocol_phase(small)
    bench_scaling_phase(*warm_phase())
    # ---- the mesh (parallel/): NCCL at world size 1, then two gloo ranks
    # on cuda:0
    ws1 = mesh_ws1_phase()
    paths["mesh_ws1"] = {k: sum(c[k] for c in ws1.values()) for k in build.REGISTRY}
    mesh_paths, r_mesh = mesh_phases(gen)
    paths.update(mesh_paths)

    main_k1 = r1[("residual", "bfloat16")]
    main_k2 = r2["bfloat16"]
    main_k3 = r3[(F, "bfloat16")]
    main_k4 = r4[("K4a", "bfloat16")]
    main_p1 = r_p1["float32"]  # the tool's first dtype; bf16 among the forms
    backward = {
        k1.KERNEL.name: [b1[(c, "bfloat16")] for c in
                         ("csc", "tres", "res_csc", "gather_rows_bwd",
                          "src_gather", "dst_gather")],
        k2.KERNEL.name: [b2["bfloat16"]],
        k3.KERNEL.name: [],  # its backward is torch's compare and where
        k4.name: [],
        p1.KERNEL.name: [],
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
                                      ("segment_sum_by", "bfloat16"))],
        p1.KERNEL.name: [r_p1["bfloat16"], *r_p1_readings]}
    # DeeperGCN's forms on the gene-level fold: K3 at F = B*H and 2*B*H, K1
    # as edge_segment_sum's forward and gather_src's backward at F = B*H
    forms[k3.KERNEL.name] = [r3[(F, "float32")], r3[(cfg.batch_size * cfg.final_channels,
                                                     "bfloat16")],
                             r3[(cfg.batch_size * cfg.final_channels, "float32")]] + list(
        dg["r3"].values())
    forms[k1.KERNEL.name] += list(dg["r1"].values())
    # MultiOmixGCN's pathway-vnode graph (f32, F = B*H) and the kNN plan
    # built on the card (F = 64)
    forms[k3.KERNEL.name] += list(dg["s11"]["r3"].values())
    forms[k1.KERNEL.name] += list(dg["s11"]["r1"].values())
    # kirc.yaml and lgg.yaml's forms at F = 4,096 (B = 64; gather_rows'
    # backward at F = 2,048)
    for (case, _), r in r_shipped.items():
        forms[(k2 if case in ("forward", "transpose") else k1).KERNEL.name].append(r)
    # the forms of gat, gcn and gin on the GBM fold (kernel_zoo)
    forms[k1.KERNEL.name] += [r for key, r in rz.items() if key[0].startswith(("gat", "gcn_res"))]
    forms[k2.KERNEL.name] += [r for key, r in rz.items() if key[0] in ("gcn_k2", "gcn_k2_t",
                                                                      "gin_k2")]
    # the stacked forms of fold-parallel CV (U = 5, F = 2,048; DeeperGCN's at
    # F = 4,096 and H = 128): each with per_unit_ms, the time of the U units'
    # own launches
    for (case, _), r in r_fp.items():
        name = {"stacked_residual": k1, "stacked_all_edges": k1, "stacked_forward": k2,
                "stacked_transpose": k2, "stacked_csr": k3, "stacked_deepergcn_csr": k3,
                "stacked_edge_segment_sum": k1, "stacked_gather_src_bwd": k1,
                "stacked_edge_id_lookup_bwd": k1}[case].KERNEL.name
        forms[name].append(r)
    # the mesh's per-rank forms (rank 0's plans of the GBM fold on two ranks)
    for form_of, r in r_mesh.values():
        forms[{"k1": k1, "k2": k2, "k3": k3}[form_of].KERNEL.name].append(r)
    # launches: the count on the kernel's first serving path (sage for K1
    # and K2, mr for K3; P1's own path, the probe); every path's count is
    # in launches_by_path
    first = {k1.KERNEL.name: "serve_sage", k2.KERNEL.name: "serve_sage",
             k3.KERNEL.name: "serve_mr", k4.name: "serve_sage",
             p1.KERNEL.name: "dma_gather"}
    # the torch.library ops each kernel backs
    ops = {k1.KERNEL.name: ["mgtpu::segment_spmm_csr", "mgtpu::segment_spmm_csr_acc"],
           k2.KERNEL.name: ["mgtpu::windowed_tile_spmm"],
           k3.KERNEL.name: ["mgtpu::segment_max_csr"],
           k4.name: ["mgtpu::sorted_segment_sum"],
           p1.KERNEL.name: ["mgtpu::dma_row_gather"]}
    kernels = []
    for k, r in ((k1.KERNEL, main_k1), (k2.KERNEL, main_k2), (k3.KERNEL, main_k3),
                 (k4, main_k4), (p1.KERNEL, main_p1)):
        kernels.append({
            "name": k.name, "route": k.route, "source": k.source_rel, "ops": ops[k.name],
            "replaces": k.replaces, "launches": paths[first[k.name]][k.name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "ms_source": r["ms_source"],
            "event_ms": r["event_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "train_launches_per_step": per_step[
                "mr" if first[k.name] == "serve_mr" else "sage"][k.name],
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
                                             "bound_by", "library_ms", "per_unit_ms",
                                             "split_rows", "chunks")}
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
