#!/usr/bin/env python3
"""Whether a train step repeats bit for bit on the card, and which
parameter's gradient does not.

    python3 probes/determinism.py

At the GBM fold of chip_smoke.py (bf16 trunk, B = 32) and on its composed
path (no window plan): one training-mode loss and its gradients, twice
from the same parameters, batch and dropout seed, under three settings in
turn: torch's defaults, torch.backends.cudnn.deterministic, and
torch.use_deterministic_algorithms(True, warn_only=True), whose warnings
name the ops without a deterministic form.  Prints one JSON line per
(setting, path): the loss difference and the parameters whose gradients
differ, with their max abs difference; then the warnings, and the card's
nvidia-smi name and power limit.  Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from multilevel_gnn_tpu_torch.data.synthetic import make_gbm_scale_setup  # noqa: E402
from multilevel_gnn_tpu_torch.train.step import make_loss_fn  # noqa: E402


def grads(model, batch, ctx, cw):
    model.train()
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    loss, _ = make_loss_fn(model.cfg)(model, batch, ctx, cw, gen)
    loss.backward()
    torch.cuda.synchronize()
    return float(loss), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def compare(setting, path, model, batch, ctx, cw):
    la, ga = grads(model, batch, ctx, cw)
    lb, gb = grads(model, batch, ctx, cw)
    diff = {n: float((ga[n] - gb[n]).abs().max()) for n in ga}
    print(json.dumps({"setting": setting, "path": path, "loss_diff": abs(la - lb),
                      "differing": {n: d for n, d in diff.items() if d > 0}}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("determinism: no CUDA device", file=sys.stderr)
        return 2
    cfg, model, graph, ctx, batch = make_gbm_scale_setup(
        topology="cohort", windowed=True, batch=32, compute_dtype="bfloat16",
        spmm_bf16=True, device="cuda")
    composed = dataclasses.replace(ctx, graph=dataclasses.replace(ctx.graph, winplan=None))
    cw = torch.tensor([1.0, 1.5], device="cuda")
    caught = []
    for setting in ("default", "cudnn_deterministic", "deterministic_algorithms"):
        if setting == "cudnn_deterministic":
            torch.backends.cudnn.deterministic = True
        if setting == "deterministic_algorithms":
            torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for path, c in (("windowed", ctx), ("composed", composed)):
                compare(setting, path, model, batch, c, cw)
        caught += sorted({str(x.message)[:200] for x in w
                          if "deterministic" in str(x.message)})
    print(json.dumps({"warnings": sorted(set(caught))}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
