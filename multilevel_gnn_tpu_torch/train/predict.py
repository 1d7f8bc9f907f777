"""Scoring from a checkpoint (port of multilevel_gnn_tpu/train/predict.py:
load_fold_state :29-96, predict_fold :99-133, main :136-181), and scoring a
patient set with a model already in memory (predict_patients).

    python -m multilevel_gnn_tpu_torch.train.predict --config configs/gbm.yaml \\
        --ckpt-dir DIR (--data-dir DIR | --synthetic) [--run 0 --fold 0] \\
        [--step E] [--split test|valid|train|all] [--out preds.json] \\
        [--set key=value ...] [--device cpu]

load_fold_state re-derives one (run, fold)'s splits and fold context as
the train driver does (fold_indices, fold_setup) and loads the model
state the driver checkpointed under --ckpt-dir; PathCNN's batches take
fold_setup's raw side channel, and vae_finetune scores its first output.  The device is CUDA unless
--device cpu is given.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, Optional

import numpy as np

from multilevel_gnn_tpu_torch.core.batch import FoldContext
from multilevel_gnn_tpu_torch.train import checkpoint as C
from multilevel_gnn_tpu_torch.train import driver


def load_fold_state(
    cfg,
    cohort,
    ckpt_dir: Optional[str],
    run_i: int = 0,
    fold_i: int = 0,
    step: Optional[int] = None,
    model=None,
    device="cuda",
) -> Dict:
    """One (run, fold)'s splits, fold context and model, shared by the
    predict and explain CLIs.

    model: a model in memory to use instead of a checkpoint (the tests'
    train -> save -> predict round trips).  With neither, the model is the
    seed-0 one, as JAX's is PRNGKey(0)'s.  Returns a dict with cfg, fold,
    ctx, X, raw (the batches' side channel, fold.raw), model and splits
    (test / valid / train / all index arrays)."""
    labels = cohort.labels()
    train_idx, valid_idx, test_idx = driver.fold_indices(labels, cfg, fold_i)
    splits = {"test": test_idx, "valid": valid_idx, "train": train_idx,
              "all": np.arange(len(labels))}
    cfg, fold, X = driver.fold_setup(cfg, cohort, train_idx, fold_i, device)
    cfg = cfg.replace(pathway_num=cohort.n_pathways)
    ctx = fold.ctx
    if model is None:
        model = driver._new_model(cfg, ctx, 0)
        if ckpt_dir is not None:
            tree, _ = C.load_checkpoint(
                os.path.join(ckpt_dir, f"run{run_i}_fold{fold_i}"), step)
            model.load_state_dict(tree["model"])
    return {"cfg": cfg, "fold": fold, "ctx": ctx, "X": X, "raw": fold.raw,
            "model": model, "splits": splits}


def predict_fold(
    cfg,
    cohort,
    ckpt_dir: Optional[str],
    run_i: int = 0,
    fold_i: int = 0,
    split: str = "test",
    step: Optional[int] = None,
    model=None,
    device="cuda",
) -> Dict:
    """Score one (run, fold)'s ``split`` patients with its checkpoint."""
    st = load_fold_state(cfg, cohort, ckpt_dir, run_i, fold_i, step, model, device)
    idx = st["splits"][split]
    out = predict_patients(st["model"], st["ctx"], st["X"], cohort.Y, cohort.ages, idx,
                           st["raw"])
    out.update(run=run_i, fold=fold_i, split=split,
               patients=[cohort.patients[i] for i in np.asarray(idx)])
    return out


def predict_patients(
    model, ctx: FoldContext, X: np.ndarray, Y: np.ndarray, ages: np.ndarray, idx,
    raw: Optional[np.ndarray] = None,
) -> Dict:
    """Probabilities of class 0 and AUC/ACC/loss for patients ``idx``, in
    batches of the model config's batch_size.

    X (P, NODES) or (P, N, omics), Y (P, 2), ages (P,) and raw (P, ...) or
    None (the batches' raw_data) are host arrays; the model and ctx sit on
    the device they run on.  "patients" lists the scored row indices."""
    idx = np.asarray(idx)
    auc, acc, y_true, score, loss = driver.evaluate(
        model, ctx, X, Y, ages, idx, model.cfg.batch_size, raw
    )
    return {
        "patients": [int(i) for i in idx],
        "prob": [float(p) for p in score],
        "y_true": [int(v) for v in y_true],
        "auc": float(auc),
        "acc": float(acc),
        "loss": float(loss),
    }


def main(argv=None) -> Dict:
    """Score a checkpointed fold; prints one JSON line and returns the
    whole result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--run", type=int, default=0)
    ap.add_argument("--fold", type=int, default=0)
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    ap.add_argument("--split", default="test",
                    choices=["test", "valid", "train", "all"])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--synthetic", action="store_true")
    src.add_argument("--data-dir", default=None)
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--out", default=None, help="predictions json path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--set", nargs="*", default=[], help="key=value overrides")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.core.device import resolve_device
    from multilevel_gnn_tpu_torch.train.cli import make_cohort, parse_overrides

    device = resolve_device(args.device)
    cfg = Config.from_yaml(args.config, **parse_overrides(args.set))
    if args.debug:
        cfg = cfg.replace(num_run=1, epochs=5, batch_size=8)
    cohort = make_cohort(cfg, args.synthetic, args.data_dir, args.debug)
    res = predict_fold(cfg, cohort, args.ckpt_dir, args.run, args.fold, args.split,
                       step=args.step, device=device)
    print(json.dumps({k: res[k] for k in ("run", "fold", "split", "auc", "acc", "loss")}),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
