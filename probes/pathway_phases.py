#!/usr/bin/env python3
"""chip_smoke.py's pathway phase alone: PW, the pathway contraction's
forward and backward kernels, at kirc's and gbm's shapes, bf16 and f32,
against their plain versions and the dense cuBLAS form, timed.

    PYTHONPATH=. python3 probes/pathway_phases.py

Prints the build line (with ptxas's registers and spills), chip_smoke's
JSON lines and the card's nvidia-smi name and power limit.  Needs one CUDA
card and nvcc.
"""
from __future__ import annotations

import sys

import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("pathway_phases: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_setup(), flush=True)
    cs.build_phase()
    cs.pathway_phase()
    return 0


if __name__ == "__main__":
    sys.exit(main())
