#!/usr/bin/env python3
"""chip_smoke.py's slice-11 phases alone, on the reference-scale protocol
files that its `cohort` phase writes: deepergcn_fold, explain_deepergcn
(16-step IG of DeeperGCN), multiomix_fold, k3_vnode / k1_vnode,
serve_multiomix_{max,softmax}, train_grad_multiomix_{max,softmax},
dyn_DynConv / dyn_ResDynBlock with k3_knn / k1_knn, minet and the dense
blocks.

    PYTHONPATH=. python3 probes/slice11_phases.py

Prints chip_smoke's JSON lines and the card's nvidia-smi name and power
limit.  Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import sys
import tempfile
import time

import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("slice11_phases: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_setup(), flush=True)
    cs.build_phase()
    gen = torch.Generator(device="cuda").manual_seed(0)
    from multilevel_gnn_tpu_torch.train import driver

    with tempfile.TemporaryDirectory() as root:
        cohort = cs.cohort_phase(root)
        t0 = time.perf_counter()
        fcfg, fold, X, (tr, _, _) = cs.dgcn_fold_phase(cohort)
        model = driver._new_model(fcfg, fold.ctx, 0)
        batch = cs.dgcn_batch(X, fold.raw, cohort, tr, fcfg.batch_size)
        cs.dgcn_explain_phase(model, fold.ctx, batch)
        del model, batch
        torch.cuda.empty_cache()
        cs.slice11_phases(fcfg, fold, X, tr, cohort, gen)
        cs.emit({"phase": "slice11_probe", "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
