#!/usr/bin/env python3
"""P1, the per-row gather probe, on one CUDA card: the counterpart of
tools/bench_dma_gather.py's main(), with the readings P1 is read by.

    python3 probes/bench_dma_gather.py
    PYTHONPATH=scratch/parent python3 probes/bench_dma_gather.py parent
    PYTHONPATH=. python3 probes/bench_dma_gather.py change

The package (and so the kernel's source) comes from the first tree on
PYTHONPATH, or from this tree when none is given; chip_smoke.py, whose
dma_gather phase does the readings, always from this tree.  So two trees'
kernels are read by the same code on one card, in turns (parent, change,
change, parent; scratch/parent: `git archive <commit> | tar -x -C
scratch/parent`).  A tree without ``dma_row_gather_ordered`` is not held
to it; every line carries ``out_sha``, the output's f32 words hashed, so
two trees' outputs can be compared bit for bit.

The kernel gathers each (16, 128) row of x3 whole with a TMA bulk copy, a
persistent block on each SM, and sums the first 128 lanes
(ops/kernels/csrc/dma_row_gather.cu).  Lines: the tree, the package's
path and the kernel's ptxas registers and shared memory; K1's csr at F
2,048 on chip_smoke.py's GBM fold, bf16 and f32; then for f32 and bf16 at
the tool's shapes (N 15,408 rows, E 165,888 gathered, chunks of te 256; x3
and src from RandomState(0) as the tool makes them), one JSON line a
reading: the tool's warm one (rows/s, device ms a call, GB/s of gathered
rows, the bound (each input byte read once) and the time of every
gathered row read from HBM, embedding_bag's ms on the same rows, the
error against the plain version, two calls equal bit for bit), cold (the
L2 flushed before each call), L2-resident and K1's stream, beside K1's
csr ms.  Then the card's nvidia-smi name and power limit.  Needs one CUDA
card and nvcc.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.append(str(ROOT))  # the package from PYTHONPATH first, else this tree


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    import torch

    from multilevel_gnn_tpu_torch.core.device import resolve_device
    from multilevel_gnn_tpu_torch.ops import spmm
    from multilevel_gnn_tpu_torch.ops.kernels import build
    from multilevel_gnn_tpu_torch.ops.kernels import dma_gather as p1
    from multilevel_gnn_tpu_torch.ops.kernels import segment_sum as k1

    resolve_device("cuda")  # raises without a card
    cs = _chip_smoke()
    smi = cs.card_setup()
    build_s = build.build_all([p1.KERNEL, k1.KERNEL])
    cs.emit({"probe": "bench_dma_gather", "tree": sys.argv[1] if len(sys.argv) > 1 else "",
             "package": str(Path(p1.__file__).resolve().parents[2]),
             "ptxas": [ln.strip() for ln in p1.KERNEL.ptxas_log.splitlines()
                       if "registers" in ln or "spill" in ln]})
    _, _, graph, _, _ = cs.gbm_fold()
    w = spmm.edge_weights(graph, "mean", graph.edge_attr)
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_ms = {}
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(graph.n_nodes, 2048, generator=gen, device="cuda").to(dt)
        r = cs.time_k1("all_edges", graph.csr, x, w, False, gen)
        cs.emit({"phase": "k1", **r})
        k1_ms[r["dtype"]] = r["ms"]
    cs.dma_gather_phase(k1_ms, build_s[p1.KERNEL.name], graph,
                        getattr(p1, "dma_row_gather_ordered", None))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
