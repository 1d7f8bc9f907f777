#!/usr/bin/env python3
"""chip_smoke.py's phases of gnn_name gat, gcn and gin and of the model
options alone, on its GBM fold: serve_<conv>, profile_<conv>,
slice_<conv>, train_grad_<conv>, train_<conv> and profile_train_<conv> for
each of the three convs, export_gat, the k1_zoo / k2_zoo kernel forms, the
options phase, and the GAT protocol card against CPU on small
reference-format files.

    PYTHONPATH=. python3 probes/zoo_phases.py [convs export zoo options protocol]

With arguments, only the named groups run (all by default).

A quicker check of those paths than the whole script.  Prints chip_smoke's
JSON lines and the card's nvidia-smi name and power limit.  Needs one CUDA
card and nvcc.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from multilevel_gnn_tpu_torch.data.synthetic import make_gbm_scale_setup, write_reference_format
from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
from multilevel_gnn_tpu_torch.ops.kernels import build


def main() -> int:
    groups = set(sys.argv[1:]) or {"convs", "export", "zoo", "options", "protocol"}
    if not torch.cuda.is_available():
        print("zoo_phases: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    build.build_all()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    cfg, _, graph, ctx, batch = make_gbm_scale_setup(
        topology="cohort", windowed=True, batch=32,
        compute_dtype="bfloat16", spmm_bf16=True, device="cuda")
    rng = np.random.RandomState(3)
    pca_seed = (rng.randn(ctx.num_pca_rows, cfg.pca_dim) * 0.05).astype(np.float32)
    ctx = dataclasses.replace(ctx, pca_seed=torch.as_tensor(pca_seed, device="cuda"))
    tcfg = cfg.replace(epochs=3, init_with_pca=True)
    n_batches = -(-cs.N_PATIENTS // cfg.batch_size)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    for conv in ("gat", "gcn", "gin") if "convs" in groups else ():
        t1 = time.perf_counter()
        cs.conv_paths(conv, tcfg, ctx, batch, n_batches)
        cs.emit({"phase": f"conv_paths_{conv}", "seconds": time.perf_counter() - t1})
    if "export" in groups:
        gat = MultilevelGNN(tcfg.replace(gnn_name="gat", final_head=cs.GBM_FINAL_HEAD),
                            graph.n_nodes, ctx.num_pca_rows, device="cuda", seed=0)
        cs.export_phase(gat, ctx, batch, "export_gat",
                        cs.conv_launches("gat", graph.winplan)[0])
        del gat
    if "zoo" in groups:
        t1 = time.perf_counter()
        cs.kernel_zoo(graph, cfg.batch_size, cfg.hidden_channels, cfg.final_channels,
                      cs.GBM_FINAL_HEAD, gen)
        cs.emit({"phase": "kernel_zoo_s", "seconds": time.perf_counter() - t1})
    if "options" in groups:
        t1 = time.perf_counter()
        cs.options_phase(tcfg, ctx, batch)
        cs.emit({"phase": "options_s", "seconds": time.perf_counter() - t1})
    if "protocol" not in groups:
        return 0
    with tempfile.TemporaryDirectory() as root:
        small = f"{root}/small"
        write_reference_format(small, cancer_type="gbm", **cs.SMALL_COHORT)
        t1 = time.perf_counter()
        cs.gat_protocol_phase(small)
        cs.emit({"phase": "gat_protocol_s", "seconds": time.perf_counter() - t1})
    cs.emit({"phase": "zoo_phases", "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
