"""Integrated gradients and the pathway survival screen (port of
multilevel_gnn_tpu/train/explain.py: integrated_gradients :57-82,
pathway_attributions :85-96, explain_cohort :99-116, main :119-213).

    python -m multilevel_gnn_tpu_torch.train.explain --config configs/gbm.yaml \\
        --ckpt-dir DIR [--data-dir DIR | --synthetic] [--run 0 --fold 0] \\
        [--step E] [--split test] [--ig-steps 16] [--top 20] \\
        [--out rows.json] [--set key=value ...] [--device cpu]

The CLI scores the split in chunks of the config's batch_size (the last
one padded, its padding rows discarded), attributes each patient's
class-0 probability to the input node values, sums |attribution| over
each pathway's genes, and screens every pathway with a Kaplan-Meier split
and the log-rank test.  The device is CUDA unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import json
import logging
from typing import Dict, List

import numpy as np
import torch

from multilevel_gnn_tpu_torch.core.batch import Batch, FoldContext
from multilevel_gnn_tpu_torch.models import refuse_unsupported
from multilevel_gnn_tpu_torch.utils.survival import pathway_km_screen


def integrated_gradients(
    model, batch: Batch, ctx: FoldContext, target_col: int = 0,
    steps: int = 32, baseline=None,
) -> torch.Tensor:
    """IG(x) = (x - x0) * mean_k d f(x0 + a_k (x - x0)) / dx, a_k the
    midpoints (k + 0.5) / steps, f = pred[:, target_col].sum() in eval
    mode, x = batch.x (the input node values, through every path the
    forward takes them: the node embedding's outer product and the value
    mask).  One forward and backward at a time, the gradients added in
    place, so memory holds one step's activations; the parameters take no
    gradient meanwhile, so the backward computes the input's only.
    batch.raw_data rides along unchanged, as in JAX (:34-35).  Returns
    x's shape: (B, NODES), or DeeperGCN's (B, N, omics)."""
    refuse_unsupported(model, "explain")
    x = batch.x.detach()
    x0 = torch.zeros_like(x) if baseline is None else baseline
    alphas = ((np.arange(steps) + 0.5) / steps).astype(np.float32)
    total = torch.zeros_like(x)
    was_training = model.training
    trainable = [p for p in model.parameters() if p.requires_grad]
    model.eval()
    try:
        for p in trainable:
            p.requires_grad_(False)
        for a in alphas:
            xi = (x0 + torch.tensor(a, dtype=x.dtype, device=x.device) * (x - x0))
            xi.requires_grad_(True)
            b = Batch(x=xi, y=batch.y, age=batch.age, sample_mask=batch.sample_mask,
                      raw_data=batch.raw_data)
            pred, _ = model(b, ctx)
            (g,) = torch.autograd.grad(pred[:, target_col].sum(), xi)
            total += g
    finally:
        model.train(was_training)
        for p in trainable:
            p.requires_grad_(True)
    return (x - x0) * total / steps


def pathway_attributions(attributions, ctx: FoldContext, n_pathways: int) -> np.ndarray:
    """(B, NODES) node-slot attributions -> (B, P) pathway scores:
    |attribution| summed over each pathway's member genes through the
    PCA-row mapping.  DeeperGCN's (B, N, omics) attributions meet a
    mapping into the 3-slot node space and raise IndexError, as JAX's
    do (:94)."""
    att = np.abs(torch.as_tensor(attributions).detach().cpu().numpy())
    match = ctx.gene_pca_match.cpu().numpy()
    slot = ctx.raw_indice.cpu().numpy() // 3  # pathway of each PCA row
    out = np.zeros((att.shape[0], n_pathways))
    valid = match >= 0
    np.add.at(out, (slice(None), slot[valid]), att[:, match[valid]])
    return out


def explain_cohort(
    model, cohort, ctx: FoldContext, batch: Batch, steps: int = 16, idx=None,
) -> List[Dict]:
    """IG and the per-pathway survival screen of one batch; rows sorted by
    log-rank p.  idx: the cohort indices of the batch rows (default: the
    first batch-size patients)."""
    ig = integrated_gradients(model, batch, ctx, steps=steps)
    scores = pathway_attributions(ig, ctx, cohort.n_pathways)
    n = scores.shape[0]
    if idx is None:
        idx = np.arange(n)
    pats = [cohort.patients[i] for i in np.asarray(idx)[:n]]
    times = np.array([cohort.survive_time[p] for p in pats])
    events = np.array([cohort.survive_state[p] for p in pats])
    return pathway_km_screen(scores, times, events, cohort.used_pathways)


def explain_split(st: Dict, cohort, split: str, ig_steps: int) -> np.ndarray:
    """(patients, P) pathway scores of a split from load_fold_state's
    ``st``, in chunks of batch_size, the tail padded and discarded."""
    idx = np.asarray(st["splits"][split])
    X, ctx, bs = np.asarray(st["X"]), st["ctx"], st["cfg"].batch_size
    dev = ctx.device
    scores = []
    for lo in range(0, len(idx), bs):
        part = idx[lo:lo + bs]
        pad = bs - len(part)
        part_p = np.concatenate([part, np.repeat(part[-1:], pad)])
        batch = Batch(
            x=torch.as_tensor(X[part_p], dtype=torch.float32).to(dev),
            y=torch.as_tensor(np.asarray(cohort.Y)[part_p], dtype=torch.float32).to(dev),
            age=torch.as_tensor(np.asarray(cohort.ages)[part_p], dtype=torch.float32).to(dev),
            sample_mask=(torch.arange(bs) < len(part)).to(dev),
        )
        ig = integrated_gradients(st["model"], batch, ctx, steps=ig_steps)
        scores.append(pathway_attributions(ig, ctx, cohort.n_pathways)[: len(part)])
    return np.concatenate(scores, axis=0)


def main(argv=None) -> Dict:
    """IG pathway attributions and the KM screen of a checkpointed fold;
    prints one JSON line (the top rows) and returns all rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--run", type=int, default=0)
    ap.add_argument("--fold", type=int, default=0)
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    ap.add_argument("--split", default="test",
                    choices=["test", "valid", "train", "all"])
    ap.add_argument("--ig-steps", type=int, default=16,
                    help="integrated-gradients midpoint steps")
    ap.add_argument("--top", type=int, default=20,
                    help="pathways printed (all rows go to --out)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--out", default=None, help="attribution rows json path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--set", nargs="*", default=[], help="key=value overrides")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.core.device import resolve_device
    from multilevel_gnn_tpu_torch.train.cli import make_cohort, parse_overrides
    from multilevel_gnn_tpu_torch.train.predict import load_fold_state

    device = resolve_device(args.device)
    cfg = Config.from_yaml(args.config, **parse_overrides(args.set))
    if args.debug:
        cfg = cfg.replace(num_run=1, epochs=5, batch_size=8)
    cohort = make_cohort(cfg, args.synthetic, args.data_dir, args.debug)
    st = load_fold_state(cfg, cohort, args.ckpt_dir, args.run, args.fold,
                         step=args.step, device=device)
    idx = np.asarray(st["splits"][args.split])
    if not len(idx):
        raise SystemExit(f"split {args.split!r} is empty for run {args.run} "
                         f"fold {args.fold}: nothing to explain")
    scores = explain_split(st, cohort, args.split, args.ig_steps)
    pats = [cohort.patients[i] for i in idx]
    times = np.array([cohort.survive_time[p] for p in pats])
    events = np.array([cohort.survive_state[p] for p in pats])
    rows = pathway_km_screen(scores, times, events, cohort.used_pathways)
    print(json.dumps({"run": args.run, "fold": args.fold, "split": args.split,
                      "patients": int(len(idx)), "top_pathways": rows[: args.top]}),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
    return {"rows": rows, "scores": scores, "patients": pats}


def script() -> None:
    """The mgtpu-torch-explain console script: main() with sys.argv, its
    return value dropped (sys.exit would report a dict as an error)."""
    main()


if __name__ == "__main__":
    main()
