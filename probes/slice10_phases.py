#!/usr/bin/env python3
"""chip_smoke.py's PathCNN, pretraining and vae_finetune phases alone, on
its GBM fold (pathcnn, pathcnn_attrs, pathcnn_vs_cpu, pretrain_autoencoder,
pretrain_vae, pretrain_vq_vae, pretrain_autoencoder_foreach,
vae_finetune_diff_pooling / _conv_head with their train_grad_ and
profile_train_ phases), then the pretrain and pathcnn protocols on small
reference-format files.

    PYTHONPATH=. python3 probes/slice10_phases.py [pathcnn pretrain vae protocol]

With arguments, only the named groups run (all by default).  A quicker
check of those paths than the whole script.  Prints chip_smoke's JSON
lines and the card's nvidia-smi name and power limit.  Needs one CUDA card
and nvcc.
"""
from __future__ import annotations

import sys
import tempfile
import time

import torch

import chip_smoke as cs


def main() -> int:
    groups = set(sys.argv[1:]) or {"pathcnn", "pretrain", "vae", "protocol"}
    if not torch.cuda.is_available():
        print("slice10_phases: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_setup(), flush=True)
    cs.build_phase()
    if groups - {"protocol"}:
        cfg, _, _, ctx, batch = cs.gbm_fold()
        cfg, ctx = cs.train_setup(cfg, ctx)
        t1 = time.perf_counter()
        if "pathcnn" in groups:
            cs.pathcnn_phase(cfg, ctx)
        if "pretrain" in groups:
            for kind in ("autoencoder", "vae", "vq_vae"):
                cs.pretrain_phase(kind, cfg, ctx, batch)
            cs.pretrain_phase("autoencoder", cfg, ctx, batch, decoder="foreach", n_steps=3)
        if "vae" in groups:
            cs.vae_finetune_phase(cfg, ctx, batch)
        cs.emit({"phase": "slice10_s", "seconds": time.perf_counter() - t1})
    if "protocol" in groups:
        with tempfile.TemporaryDirectory() as root:
            small = cs.small_files(root)
            t1 = time.perf_counter()
            cs.pretrain_protocol_phase(small)
            cs.emit({"phase": "protocols_s", "seconds": time.perf_counter() - t1})
    return 0


if __name__ == "__main__":
    sys.exit(main())
