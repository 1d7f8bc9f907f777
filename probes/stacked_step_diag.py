#!/usr/bin/env python3
"""Where a stacked (fold-parallel) train step's gradients part from the
units' own steps' on the card:

    PYTHONPATH=. python3 probes/stacked_step_diag.py

The fixture of tests/test_torch_cuda_kernels.py:
test_stacked_step_matches_unit_steps: three small windowed cohort-topology
folds (make_gbm_scale_setup, batch 8, 12 pathways) at node_num 300 (900
slots, one window: no residual edges) and 400 (1,200 slots, two windows:
residual and tres edges), f32 and bf16 trunks, with TF32 as torch leaves
it (cuDNN on, cuBLAS off) and with TF32 off for both.  The head's
convolutions run with TF32 off whatever the flag says
(models/multilevel_gnn.py:_Conv2d), so the two settings should read
alike; before they did, cuDNN's TF32 parted the stacked step's grouped
head convolution from a unit's own by up to 9.3e-2.  Each unit's
first-step gradients four ways: stacked with kernels (SK), stacked with
plain versions (SP), own with kernels (OK), own with plain versions (OP);
one JSON line a case with the three worst parameters, max|diff| /
max|grad|, of SK against OK, SP against OP, SK against SP and OK against
OP.  Kernels against plain versions (SK/SP, OK/OP) split what the kernels
add from what the stacked step's dense ops add (SP/OP).  Then the card's
nvidia-smi name and power limit.  Needs one CUDA card.
"""
from __future__ import annotations

import copy
import json
import subprocess

import torch

from multilevel_gnn_tpu_torch.core.batch import Batch, stack_contexts
from multilevel_gnn_tpu_torch.data.synthetic import make_gbm_scale_setup
from multilevel_gnn_tpu_torch.nn.basic import UnitGenerators
from multilevel_gnn_tpu_torch.ops import spmm
from multilevel_gnn_tpu_torch.train import step as S

UNITS = 3


def fixture(node_num, dtype, dev):
    return [make_gbm_scale_setup(node_num=node_num, n_pathways=12, batch=8, gene_rows=900,
                                 topology="cohort", windowed=True, device=dev,
                                 compute_dtype=dtype, spmm_bf16=dtype is not None,
                                 seed=u, topo_seed=u) for u in range(UNITS)]


def maybe_plain(plain):
    return spmm.plain_versions() if plain else torch.enable_grad()


def stacked(sets, cfg, plain, dev):
    models = [copy.deepcopy(s[1]) for s in sets]
    params = S.stack_params(models)
    opt = S.Optimizer(list(params.values()), cfg, 4, units=UNITS)
    opt.step = lambda: None
    gens = UnitGenerators(torch.Generator(device=dev).manual_seed(7 + u) for u in range(UNITS))
    batch = Batch(*(torch.stack([getattr(s[4], f) for s in sets])
                    for f in ("x", "y", "age", "sample_mask")))
    cw = torch.tensor([[1.0, 1.5]] * UNITS, device=dev)
    with maybe_plain(plain):
        S.stacked_train_step(copy.deepcopy(models[0]), params, opt, batch,
                             stack_contexts([s[3] for s in sets]), cw, gens)
    return [{n: p.grad[u].clone() for n, p in params.items() if p.grad is not None}
            for u in range(UNITS)]


def own(sets, cfg, plain, dev):
    out = []
    cw = torch.tensor([1.0, 1.5], device=dev)
    for u, s in enumerate(sets):
        m = copy.deepcopy(s[1])
        m.train()
        m.zero_grad()
        with maybe_plain(plain):
            loss, _ = S.make_loss_fn(cfg)(m, s[4], s[3], cw,
                                          torch.Generator(device=dev).manual_seed(7 + u))
            loss.backward()
        out.append({n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None})
    return out


def worst(a, b, n=3):
    res = sorted(((float((a[u][k] - b[u][k]).abs().max())
                   / max(float(b[u][k].abs().max()), 1e-30), u, k)
                  for u in range(UNITS) for k in a[u]), reverse=True)
    return res[:n]


def main():
    dev = torch.device("cuda")
    for tf32 in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = tf32
        for node_num in (300, 400):
            for dtype in (None, "bfloat16"):
                sets = fixture(node_num, dtype, dev)
                cfg = sets[0][0].replace(gnn_dropout=0.25)
                sk, sp = stacked(sets, cfg, False, dev), stacked(sets, cfg, True, dev)
                ok_, op = own(sets, cfg, False, dev), own(sets, cfg, True, dev)
                print(json.dumps({
                    "cudnn_tf32": tf32, "node_num": node_num, "trunk": dtype or "float32",
                    "n_res": [s[2].winplan.n_res for s in sets],
                    "n_tres": [s[2].winplan.n_tres for s in sets],
                    "SK_vs_OK": worst(sk, ok_), "SP_vs_OP": worst(sp, op),
                    "SK_vs_SP": worst(sk, sp), "OK_vs_OP": worst(ok_, op)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
