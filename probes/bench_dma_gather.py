#!/usr/bin/env python3
"""P1, the per-row gather probe, on one CUDA card: the counterpart of
tools/bench_dma_gather.py's main().

    python3 probes/bench_dma_gather.py

The kernel gathers each (16, 128) row of x3 with one TMA bulk copy and sums
the first 128 lanes (ops/kernels/csrc/dma_row_gather.cu).  At the tool's
shapes (N 15,408 rows, E 165,888 gathered, chunks of te 256; x3 and src
from RandomState(0) as the tool makes them), for f32 and then bf16, one
JSON line each, from chip_smoke.py's dma_gather phase: rows/s, device ms a
call, GB/s of gathered rows, the kernel's build seconds, the bound (each
input byte read once) and the time of every gathered row read from HBM,
embedding_bag's ms on the same rows, the error against the plain version
and whether two calls are equal bit for bit.  Then the card's nvidia-smi
name and power limit.  Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from multilevel_gnn_tpu_torch.core.device import resolve_device  # noqa: E402
from multilevel_gnn_tpu_torch.ops.kernels import build  # noqa: E402
from multilevel_gnn_tpu_torch.ops.kernels import dma_gather as p1  # noqa: E402


def main() -> int:
    resolve_device("cuda")  # raises without a card
    smi = cs.card_setup()
    build_s = build.build_all([p1.KERNEL])[p1.KERNEL.name]
    cs.dma_gather_phase(build_s=build_s)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
