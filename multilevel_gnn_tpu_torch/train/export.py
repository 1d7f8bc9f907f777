"""Exported inference for a trained fold (port of
multilevel_gnn_tpu/train/export.py: export_fold :39-97, save_exported
:100-110, load_exported :113-131, main :134-188).

The JAX package serializes the fold's eval function as StableHLO beside a
flat npz of its parameter and context leaves.  Here the fold's eval forward
is a ``torch.export`` program: the model's parameters, and every tensor of
the fold context registered as a buffer, are saved in the program, and the
kernels appear in its graph as the custom ops ``mgtpu::*``.  The program
is traced under ``torch.no_grad()`` with the parameters frozen, so the
autograd Functions around the kernels (ops/spmm.py) run their forwards
only.  The format and the loader, which needs no model code, are in
``multilevel_gnn_tpu_torch/artifact.py``.

    python -m multilevel_gnn_tpu_torch.train.export --config configs/gbm.yaml \\
        --ckpt-dir CKPT [--data-dir DIR | --synthetic] [--run 0 --fold 0] \\
        [--step E] [--batch-size B] --out EXPORT_DIR [--device cpu]

The CLI ends with JAX's self-check: the artifact, loaded again, scores a
batch of the fold's test split, and one JSON line is printed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from multilevel_gnn_tpu_torch.artifact import load_exported, save_exported
from multilevel_gnn_tpu_torch.core.batch import Batch
from multilevel_gnn_tpu_torch.models import refuse_unsupported

__all__ = ["export_fold", "export_program", "save_exported", "load_exported", "main"]


def _map_tensors(obj, fn: Callable, path: str = "ctx"):
    """obj with every tensor t inside it (through nested dataclasses)
    replaced by fn(path, t); path names the field chain, '__'-joined."""
    if isinstance(obj, torch.Tensor):
        return fn(path, obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v):
                changes[f.name] = _map_tensors(v, fn, f"{path}__{f.name}")
        return dataclasses.replace(obj, **changes)
    return obj


class FoldInference(nn.Module):
    """The model and its fold context as one module: forward(x, age) ->
    (B, 2) eval-mode probabilities.  Each context tensor is a buffer, so
    torch.export saves it in the program; forward rebuilds the context
    from the buffers."""

    def __init__(self, model: nn.Module, ctx):
        super().__init__()
        self.model = model

        def register(path, t):
            if t.numel() == 0:
                # an empty plan array made by torch.from_numpy has stride 0,
                # which torch.export.save cannot write; a new one has 1
                t = torch.empty_like(t, memory_format=torch.contiguous_format)
            self.register_buffer(path, t)
            return t

        self._ctx = _map_tensors(ctx, register)

    def forward(self, x: torch.Tensor, age: torch.Tensor) -> torch.Tensor:
        ctx = _map_tensors(self._ctx, lambda path, _: getattr(self, path))
        # the forward reads x and age only; y and sample_mask feed the loss
        batch = Batch(x=x, y=None, age=age, sample_mask=None)
        return self.model(batch, ctx)[0]


def export_program(model: nn.Module, ctx, batch_size: int, n_nodes: int):
    """torch.export program of FoldInference(model, ctx) at a fixed batch
    size, traced under torch.no_grad(); the model is put in eval mode and
    its parameters frozen (requires_grad False).  x is (B, n_nodes), as
    JAX's export_fold gives it (:73), so DeeperGCN, which unpacks a 3-D
    x, raises ValueError in its forward, as JAX's does."""
    refuse_unsupported(model, "export")
    model.eval()
    for p in model.parameters():
        p.requires_grad_(False)
    mod = FoldInference(model, ctx)
    x = torch.zeros((batch_size, n_nodes), dtype=torch.float32, device=ctx.device)
    age = torch.zeros((batch_size,), dtype=torch.float32, device=ctx.device)
    with torch.no_grad():
        return torch.export.export(mod, (x, age), strict=False)


def export_fold(
    cfg,
    cohort,
    ckpt_dir: Optional[str],
    run_i: int = 0,
    fold_i: int = 0,
    step: Optional[int] = None,
    batch_size: Optional[int] = None,
    params: Optional[Dict[str, torch.Tensor]] = None,
    device="cuda",
) -> Dict:
    """Export one (run, fold)'s inference function at a fixed batch size
    (the config's by default).  params: a state_dict to use instead of the
    checkpoint under ckpt_dir (the tests carry the JAX package's
    parameters in through interop.py).  Returns {"program":
    ExportedProgram, "meta": dict, "state": load_fold_state's dict}."""
    from multilevel_gnn_tpu_torch.train.predict import load_fold_state

    st = load_fold_state(cfg, cohort, None if params is not None else ckpt_dir,
                         run_i, fold_i, step, device=device)
    cfg, model, ctx = st["cfg"], st["model"], st["ctx"]
    if params is not None:
        model.load_state_dict(params)
    B = batch_size or cfg.batch_size
    n_nodes = int(np.asarray(st["X"]).shape[1])
    program = export_program(model, ctx, B, n_nodes)
    meta = {
        "batch_size": B,
        "n_nodes": n_nodes,
        "n_tensors": len(program.state_dict) + len(program.constants),
        "platforms": [ctx.device.type],
        "run": run_i,
        "fold": fold_i,
        "cancer_type": cfg.cancer_type,
        "model": cfg.model,
    }
    return {"program": program, "meta": meta, "state": st}


def main(argv=None) -> Dict:
    """Export a checkpointed fold, then score a test-split batch with the
    artifact loaded again; prints one JSON line and returns it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--run", type=int, default=0)
    ap.add_argument("--fold", type=int, default=0)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None,
                    help="serving batch size baked into the artifact "
                         "(default: the config's training batch size)")
    ap.add_argument("--out", required=True, help="export directory")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--set", nargs="*", default=[], help="key=value overrides")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.core.device import resolve_device
    from multilevel_gnn_tpu_torch.train.cli import make_cohort, parse_overrides
    from multilevel_gnn_tpu_torch.train.step import eval_step

    device = resolve_device(args.device)
    cfg = Config.from_yaml(args.config, **parse_overrides(args.set))
    if args.debug:
        cfg = cfg.replace(num_run=1, epochs=5, batch_size=8)
    cohort = make_cohort(cfg, args.synthetic, args.data_dir, args.debug)
    ex = export_fold(cfg, cohort, args.ckpt_dir, args.run, args.fold,
                     step=args.step, batch_size=args.batch_size, device=device)
    save_exported(args.out, ex)

    # self-check: the artifact, loaded again, against the live model on a
    # batch of this fold's test split
    infer = load_exported(args.out)
    st = ex["state"]
    B = ex["meta"]["batch_size"]
    idx = np.asarray(st["splits"]["test"][:B])
    if len(idx) == 0:
        idx = np.arange(min(B, len(cohort.patients)))
    idx = np.concatenate([idx, np.repeat(idx[-1:], B - len(idx))])
    X = np.asarray(st["X"])
    x, age = X[idx], np.asarray(cohort.ages)[idx]
    probs = infer(x, age)
    live, _ = eval_step(st["model"], Batch(
        x=torch.as_tensor(x, device=device), y=torch.zeros((B, 2), device=device),
        age=torch.as_tensor(age, device=device),
        sample_mask=torch.ones(B, dtype=torch.bool, device=device)), st["ctx"])
    line = {**ex["meta"], "out": args.out, "selfcheck_prob0": float(probs[0, 0]),
            "selfcheck_max_abs_diff": float((probs - live).abs().max())}
    print(json.dumps(line), flush=True)
    return line


def script() -> None:
    """The mgtpu-torch-export console script: main() with sys.argv, its
    return value dropped (sys.exit would report a dict as an error)."""
    main()


if __name__ == "__main__":
    main()
