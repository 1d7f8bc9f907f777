"""Fold-parallel CV: every (run, fold) unit advances in lockstep (port of
multilevel_gnn_tpu/train/fold_parallel.py: _Unit :62, _pad_batch :71,
recommended_arm :79, run_experiment_foldparallel :87-647).

The protocol is num_run x 5-fold CV, 150 independent trainings for the
published 30 runs.  Here all of them advance as one step over a stacked
unit axis (train/step.py: stacked_train_step, stacked_eval_step): the
model's forward runs under torch.vmap over the units' stacked parameters,
each SpMM and segment op of all units is one launch of its kernel over the
block-diagonal plans of core/batch.py:stack_contexts (K1, K2 and K3 launch
as often in a stacked step as in one unit's), and each dense op is one
batched op.  The JAX package vmaps its step, its Pallas kernels taking a
unit grid axis; the block-diagonal plan is the counterpart of that axis.

The semantics are the JAX driver's: per-unit host RNG streams
(np.random.RandomState(seed + 1000 * run + fold)), the per-unit model seed
seed * 10000 + run * 100 + fold with per-unit PCA seeding, each unit's
dropout masks from its own torch.Generator seeded as run_fold seeds it
(nn/basic.py:UnitGenerators), one step counter for all units, the LR
schedule keyed on floor(n / batch_size), per-unit best-by-valid-AUC /
best-by-valid-loss selection and pooled check-epoch scoring.  Lockstep
needs one train-step count: units whose split gives more batches are
trimmed to the minimum, with a warning (the shipped 5-fold protocol's
splits differ by at most one patient).  Ragged eval batch counts are
padded with all-masked batches, whose predictions and losses are dropped.

Left out: the JAX package's one-dispatch arm (use_fold_scan, the whole
experiment as one vmapped train_fold_raw), which only changes how JAX
dispatches the same steps; the port always runs the lockstep loop and
reports "arm": "per-step", as train/driver.py leaves out epoch_scan /
fold_scan.  devices=N runs N groups of the units, each group stacked on
its own device (cuda:0 .. N-1, or N groups on the CPU), with no
collectives; with more groups than cards, group g takes card g modulo
the count and the groups on a card step in turn.  So one H100 runs the
published 150 units (about 0.9 GB of activations each in a GBM-scale
bf16 step, PERF.md), which do not fit its 80 GB as one group, as
devices=2 or more.

Every model of the registry goes through here, as through JAX's.
MultilevelGNN, DeeperGCN, PathCNN and vae_finetune run stacked: a fold's
raw side channel (DeeperGCN's pathway node attrs, PathCNN's PCA-row values
or pathway image) is kept on the group's device once per fold and each
unit's batch rows are gathered from its fold's, so raw_data enters the
stacked step as a (U, B, ...) leaf; DeeperGCN's edge-id lookup and
DiffPool's pathway adjacency ride the stacked context
(core/batch.py:stack_contexts).  DeeperGCN's units start from the model's
own init, without apply_init_weight: JAX's fold-parallel leaves that
re-init out (fold_parallel.py:170-192) where its run_fold applies it, so
both packages' fold-parallel DeeperGCN starts elsewhere than their
sequential drivers (ROADMAP section 3).  The models JAX's cannot train
fail as they do there, in the first stacked step's forward, before any
update: MultiOmixGCN (AttributeError: its forward takes the pathway attrs
where the step passes the generators), the AutoEncoder (TypeError: its
reconstruction against the (B, 2) targets), the VAE (RuntimeError naming
flax's InvalidRngError: its training draw has no 'sample' stream) and
the VQ-VAE (KeyError: its output is a dict).

Checkpoints (ckpt_dir) are per unit, in run_fold's layout
(run{r}_fold{f}/step_{e} plus its host state), every cfg.ckpt_every
epochs, or at the last epoch when it is 0; predict reads them unchanged,
and resume=True restarts every unit at the latest epoch all of them have.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from multilevel_gnn_tpu_torch.core.batch import Batch, stack_contexts
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.core.device import resolve_device
from multilevel_gnn_tpu_torch.models.multilevel_gnn import seed_pca_params
from multilevel_gnn_tpu_torch.nn.basic import UnitGenerators
from multilevel_gnn_tpu_torch.train import checkpoint as C
from multilevel_gnn_tpu_torch.train import driver
from multilevel_gnn_tpu_torch.train import metrics as M
from multilevel_gnn_tpu_torch.train.driver import (
    epoch_plan,
    fold_features,
    fold_setup,
    stratified_kfold,
)
from multilevel_gnn_tpu_torch.train.step import (
    Optimizer,
    stack_params,
    stacked_eval_step,
    stacked_train_step,
    unit_state_dict,
)

log = logging.getLogger("mgtpu.fold_parallel")


@dataclasses.dataclass
class _Unit:
    run_i: int
    fold_i: int
    train_idx: np.ndarray
    valid_idx: np.ndarray
    test_idx: np.ndarray


def _pad_batch(like):
    """An all-masked clone of a unit's batch plan ``like`` = (take,
    sample_mask): it contributes no predictions, and pads ragged eval batch
    counts."""
    take, mask = like
    return take, np.zeros_like(mask)


def recommended_arm(n_devices: int) -> str:
    """'sequential' | 'fold_parallel': fold-parallel's regime is units
    spread over more than one device.  On one NVIDIA H100 (700 W) the
    stacked step of five GBM-scale units took 45.6-45.8 ms against
    45.5-75.4 ms for their five own steps: faster only where the host
    lags, since its kernels take 9% longer; the 1-run protocol on
    reference-scale files took about as long as the sequential driver,
    which derives the next fold while one trains (PERF.md,
    chip_smoke.py's fold_parallel phases).  So sequential stays the
    one-device arm."""
    return "fold_parallel" if n_devices > 1 else "sequential"


class _Group:
    """The units on one device, stacked: the fold contexts, the parameters
    (with a template model whose parameters functional_call replaces), the
    optimizer over them, the dropout generators, the class weights, the
    data (with each fold's raw side channel once) and the epoch's batch
    plans."""

    def __init__(self, cfg, units, folds, X, Y, ages, device, steps_per_epoch):
        self.units, self.device = units, device
        names = [f"run {u.run_i} fold {u.fold_i}" for u in units]
        ctxs = [folds[u.fold_i].ctx for u in units]
        self.sctx = stack_contexts(ctxs, names)
        models = []
        for u, ctx in zip(units, ctxs):
            model = driver._new_model(cfg, ctx, cfg.seed * 10_000 + u.run_i * 100 + u.fold_i,
                                      init_weight=False)
            if cfg.init_with_pca and ctx.pca_seed is not None:
                seed_pca_params(model, ctx.pca_seed)
            models.append(model)
        self.params = stack_params(models)
        self.model = models[0]
        del models
        self.optimizer = Optimizer(list(self.params.values()), cfg, steps_per_epoch,
                                   units=len(units))
        self.gens = UnitGenerators(
            torch.Generator(device=device).manual_seed(
                cfg.seed * 10_000 + u.run_i * 100 + u.fold_i) for u in units)
        self.cw = torch.as_tensor(np.stack(
            [folds[u.fold_i].class_weight for u in units]).astype(np.float32)).to(device)
        self.data = {k: torch.as_tensor(np.asarray(a, np.float32)).to(device)
                     for k, a in (("x", X), ("y", Y), ("age", ages))}
        # the group's folds' raw side channels, each fold's once: (n_folds *
        # P, ...) rows, unit u's fold's rows from raw_offset[u] on
        self.raw = self.raw_offset = None
        fold_ids = sorted({u.fold_i for u in units})
        if folds[fold_ids[0]].raw is not None:
            self.raw = torch.as_tensor(np.concatenate(
                [folds[f].raw for f in fold_ids]).astype(np.float32)).to(device)
            n = len(folds[fold_ids[0]].raw)
            self.raw_offset = torch.as_tensor(
                [fold_ids.index(u.fold_i) * n for u in units]).to(device)
        self.mults = None

    def batch(self, take: torch.Tensor, mask: torch.Tensor, mult=None) -> Batch:
        """The (U, B, ...) batch of the (U, B) rows take, gathered here;
        each unit's raw_data rows from its own fold's side channel."""
        flat = take.reshape(-1)
        shape = tuple(take.shape)
        x = self.data["x"].index_select(0, flat).reshape(shape + self.data["x"].shape[1:])
        raw = None
        if self.raw is not None:
            rows = (take + self.raw_offset[:, None]).reshape(-1)
            raw = self.raw.index_select(0, rows).reshape(shape + self.raw.shape[1:])
        return Batch(
            x=x * mult if mult is not None else x,
            y=self.data["y"].index_select(0, flat).reshape(shape + (2,)),
            age=self.data["age"].index_select(0, flat).reshape(shape),
            sample_mask=mask,
            raw_data=raw,
        )

    def load_epoch(self, plans) -> None:
        """The epoch's train plans of each unit (lists of (take, mask,
        mult)), copied here once as (S, U, B) tensors."""
        def stacked(j):
            return np.stack([np.stack([p[s][j] for p in plans]) for s in range(len(plans[0]))])

        if not plans or not plans[0]:
            self.takes = None
            return
        self.takes = torch.as_tensor(stacked(0)).to(self.device)
        self.masks = torch.as_tensor(stacked(1)).to(self.device)
        self.mults = (torch.as_tensor(stacked(2)).to(self.device)
                      if plans[0][0][2] is not None else None)

    def step(self, s: int) -> torch.Tensor:
        mult = self.mults[s] if self.mults is not None else None
        batch = self.batch(self.takes[s], self.masks[s], mult)
        return stacked_train_step(self.model, self.params, self.optimizer, batch,
                                  self.sctx, self.cw, self.gens)

    def set_eval_plans(self, X, splits, batch_size: int) -> None:
        """Per split, each unit's eval batches (in index order) padded to
        the group's largest count with all-masked batches: (n_b, U, B)
        takes and masks here, and (n_b, U) real-batch flags on the host."""
        self.eval_plans = {}
        for name in splits:
            per = [[(t, m) for t, m, _ in epoch_plan(X, getattr(u, name), batch_size)]
                   for u in self.units]
            n_b = max(len(p) for p in per)
            real = np.array([[bi < len(p) for p in per] for bi in range(n_b)], bool)
            rows = [[p[bi] if bi < len(p) else _pad_batch(p[0]) for p in per]
                    for bi in range(n_b)]
            take = torch.as_tensor(np.array([[r[0] for r in row] for row in rows])).to(self.device)
            mask = np.array([[r[1] for r in row] for row in rows])
            self.eval_plans[name] = (take, torch.as_tensor(mask).to(self.device), mask, real)

    def evaluate(self, name: str):
        """(preds, losses) of every eval batch of split ``name``: host
        arrays (n_b, U, B, 2) and (n_b, U), one copy from the device."""
        take, mask, _, _ = self.eval_plans[name]
        preds, losses = [], []
        for bi in range(take.shape[0]):
            pred, loss = stacked_eval_step(self.model, self.params,
                                           self.batch(take[bi], mask[bi]), self.sctx)
            preds.append(pred.float())
            losses.append(loss)
        return (torch.stack(preds).cpu().numpy(), torch.stack(losses).cpu().numpy())


def _load_units(groups, tags, epoch0):
    """Each unit's checkpoint at epoch0 into its group's stacked state;
    returns the units' host states in group order."""
    hosts = []
    k = 0
    for g in groups:
        trees = []
        for _ in g.units:
            tree, _ = C.load_checkpoint(tags[k], epoch0)
            trees.append(tree)
            hosts.append(C.load_host_state(tags[k], epoch0))
            k += 1
        with torch.no_grad():
            for name, p in g.params.items():
                p.copy_(torch.stack([t["model"][name] for t in trees]).to(p.device))
        g.optimizer.load_state_dict(C.stack_trees([t["optimizer"] for t in trees]))
        for gen, t in zip(g.gens, trees):
            gen.set_state(t["generator"])
    return hosts


def run_experiment_foldparallel(
    cfg: Config,
    cohort,
    devices: Optional[int] = None,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    device="cuda",
) -> Dict:
    """Fold-parallel equivalent of driver.run_experiment (module docstring).

    devices: N groups of the units (num_run * 5 must divide by N), group g
    on cuda:(g modulo the card count), or all N on the CPU with
    device='cpu'; None = one group on ``device``.  ckpt_dir / resume: per-unit checkpoints in run_fold's
    layout (module docstring).  Returns run_experiment's pooled keys
    (check_epochs, auc, auc_by_loss, auc_by_epoch, acc, acc_by_loss,
    acc_by_epoch and their _std / _all), wall_time_s, epoch_s_median,
    units, arm ("per-step"), devices and step_ms_median (the median
    CUDA-event ms of one stacked step of every group, None on the CPU);
    also epoch_s (host s of each epoch run) and setup_s (s deriving the
    folds, and stacking the groups: contexts, models, eval plans)."""
    t0 = time.perf_counter()
    labels = cohort.labels()
    check_epochs = list(range(5, cfg.epochs + 1, 5)) or [cfg.epochs]
    outer = stratified_kfold(labels, 5, cfg.split_shaffle, cfg.split_seed)
    units: List[_Unit] = []
    for run_i in range(cfg.num_run):
        for fold_i, (tune, test_idx) in enumerate(outer):
            tr, va = stratified_kfold(labels[tune], 5, cfg.split_shaffle, cfg.split_seed)[0]
            units.append(_Unit(run_i, fold_i, tune[tr], tune[va], test_idx))
    F = len(units)
    n_groups = devices or 1
    assert F % n_groups == 0, (F, devices)
    dev = resolve_device(device)
    group_devs = [torch.device("cuda", g % torch.cuda.device_count())
                  if dev.type == "cuda" and devices else dev for g in range(n_groups)]

    # ---- per-fold data: runs share splits, so 5 distinct folds a device
    fold_cache: Dict = {}
    fcfg = None
    for gdev in dict.fromkeys(group_devs):
        for u in units:
            if (u.fold_i, gdev) not in fold_cache:
                fcfg, fold, _ = fold_setup(cfg, cohort, u.train_idx, u.fold_i, gdev)
                fold_cache[(u.fold_i, gdev)] = fold
    cfg = fcfg.replace(pathway_num=cohort.n_pathways)
    X = fold_features(cfg, cohort)
    t_folds = time.perf_counter()
    Y, ages = cohort.Y, cohort.ages
    shuffle = not cfg.class_sample
    drop_last = not (cfg.class_sample or cfg.weighted_loss or cfg.batch_weighted_loss)
    # the LR schedule keys on floor(n / bs), as run_fold's; the train batches
    # an epoch follow epoch_plan's drop_last (ceil without it)
    steps_per_epoch = max(min(len(u.train_idx) // cfg.batch_size for u in units), 1)
    n_batches = [len(u.train_idx) // cfg.batch_size if drop_last
                 else -(-len(u.train_idx) // cfg.batch_size) for u in units]
    train_batches = min(n_batches)
    if len(set(n_batches)) > 1:
        log.warning("fold-parallel lockstep: ragged train batches/epoch %s -> %d",
                    sorted(set(n_batches)), train_batches)

    per = F // n_groups
    groups = []
    for g, gdev in enumerate(group_devs):
        mine = units[g * per:(g + 1) * per]
        folds = {u.fold_i: fold_cache[(u.fold_i, gdev)] for u in mine}
        grp = _Group(cfg, mine, folds, X, Y, ages, gdev, steps_per_epoch)
        grp.set_eval_plans(X, ("valid_idx", "test_idx"), cfg.batch_size)
        groups.append(grp)
    t_stack = time.perf_counter()

    results = [dict(highest_valid=-1.0, highest_valid_loss=100.0, result_y=None,
                    result_y_by_loss=None, epoch={}, epoch_by_loss={}, epoch_by_epoch={})
               for _ in units]
    y_true_test: List = [None] * F
    np_rngs = [np.random.RandomState(cfg.seed + 1000 * u.run_i + u.fold_i) for u in units]
    sampler_weights = []
    for u in units:
        fold = fold_cache[(u.fold_i, group_devs[0])]
        cls = (np.asarray(Y)[:, 1] > 0.5).astype(np.int64)[np.asarray(u.train_idx)]
        sampler_weights.append(np.asarray(fold.class_weight)[cls] if cfg.class_sample else None)
    variation = ({"prob": cfg.random_variation_prob, "range": cfg.random_range}
                 if cfg.random_variation_aug else None)
    tags = ([os.path.join(ckpt_dir, f"run{u.run_i}_fold{u.fold_i}") for u in units]
            if ckpt_dir is not None else None)
    start_epoch, step_i = 1, 0
    if tags is not None and resume:
        lasts = [C.latest_resumable_step(t) for t in tags]
        if all(last is not None for last in lasts):
            epoch0 = min(lasts)  # lockstep: the latest epoch every unit has
            for i, host in enumerate(_load_units(groups, tags, epoch0)):
                results[i], y_true_test[i] = host["results"], host["y_true_test"]
                step_i = host["step_i"]
                np_rngs[i].set_state(host["np_rng_state"])
            start_epoch = epoch0 + 1
            log.info("fold-parallel resumed %d units at epoch %d", F, epoch0)
        else:
            log.warning(
                "--resume requested but %d/%d units have no complete checkpoint "
                "(lockstep resume needs all of them); restarting the experiment "
                "from epoch 1", sum(last is None for last in lasts), F)

    def save(epoch):
        """Each unit's state in run_fold's layout."""
        i = 0
        for g in groups:
            opt_state = g.optimizer.state_dict()
            for j, u in enumerate(g.units):
                tree = {"model": unit_state_dict(g.model, g.params, j),
                        "optimizer": C.unit_tree(opt_state, j),
                        "generator": g.gens[j].get_state()}
                C.save_tree(tags[i], tree, {"run": u.run_i, "fold": u.fold_i, "epoch": epoch},
                            step=epoch)
                C.save_host_state(tags[i], epoch, {
                    "results": results[i], "y_true_test": y_true_test[i], "step_i": step_i,
                    "np_rng_state": np_rngs[i].get_state()})
                C.prune_old_steps(tags[i], cfg.ckpt_keep)
                i += 1

    def record(i, epoch, v_auc, v_acc, v_loss, t_score):
        r = results[i]
        v_eval = v_auc if cfg.metrics == "auc" else v_acc
        if v_loss < r["highest_valid_loss"]:
            r["highest_valid_loss"] = v_loss
            r["result_y_by_loss"] = t_score
        if v_eval > r["highest_valid"]:
            r["highest_valid"] = v_eval
            r["result_y"] = t_score
        if epoch in check_epochs:
            for key, best in (("epoch", "result_y"), ("epoch_by_loss", "result_y_by_loss")):
                r[key][epoch] = r[best] if r[best] is not None else t_score
            r["epoch_by_epoch"][epoch] = t_score

    def scores(name):
        """Per unit, (auc, acc, y_true, score0, mean loss) of split name."""
        out = []
        for g in groups:
            preds, losses = g.evaluate(name)
            _, _, mask, real = g.eval_plans[name]
            for j, u in enumerate(g.units):
                bs = np.flatnonzero(real[:, j])
                p = np.concatenate([preds[b, j][mask[b, j]] for b in bs])
                idx = getattr(u, name)
                auc, acc, y_true, score0 = M.eval_scores(np.asarray(Y)[idx], p)
                out.append((auc, acc, y_true, score0, float(np.mean([float(v) for v in
                                                                      losses[bs, j]]))))
        return out

    timed = group_devs[0].type == "cuda"
    epoch_times: List[float] = []
    step_ms: List[float] = []
    for epoch in range(start_epoch, cfg.epochs + 1):
        t_ep = time.perf_counter()
        plans = [list(itertools.islice(
            epoch_plan(X, u.train_idx, cfg.batch_size, np_rngs[i], shuffle, drop_last,
                       sampler_weights[i], variation), train_batches))
            for i, u in enumerate(units)]
        for g_i, g in enumerate(groups):
            g.load_epoch(plans[g_i * per:(g_i + 1) * per])
        events = []
        for s in range(train_batches):
            if timed:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            for g in groups:
                g.step(s)
            if timed:
                ev[1].record()
                events.append(ev)
            step_i += 1
        if events:
            events[-1][1].synchronize()
        step_ms += [a.elapsed_time(b) for a, b in events]
        val, tst = scores("valid_idx"), scores("test_idx")
        for i in range(F):
            v_auc, v_acc, _, _, v_loss = val[i]
            _, _, y_true_test[i], t_score, _ = tst[i]
            record(i, epoch, v_auc, v_acc, v_loss, t_score)
        epoch_times.append(time.perf_counter() - t_ep)
        log.info("fold-parallel epoch %d (%d units): %.2fs", epoch, F, epoch_times[-1])
        if tags is not None and ((cfg.ckpt_every > 0 and epoch % cfg.ckpt_every == 0)
                                 or (cfg.ckpt_every <= 0 and epoch == cfg.epochs)):
            save(epoch)

    # ---- pooled check-epoch aggregation (as run_experiment's)
    agg = {k: {e: [] for e in check_epochs}
           for k in ("auc", "auc_by_loss", "auc_by_epoch", "acc", "acc_by_loss",
                     "acc_by_epoch")}
    for run_i in range(cfg.num_run):
        sel = [i for i, u in enumerate(units) if u.run_i == run_i]
        y = np.concatenate([y_true_test[i] for i in sel])
        for e in check_epochs:
            for key, attr in (("auc", "epoch"), ("auc_by_loss", "epoch_by_loss"),
                              ("auc_by_epoch", "epoch_by_epoch")):
                pred = np.concatenate([results[i][attr][e] for i in sel])
                agg[key][e].append(M.roc_auc(y, pred))
                agg[key.replace("auc", "acc")][e].append(M.accuracy(y, pred > 0.5))
    out = {
        "check_epochs": check_epochs,
        "wall_time_s": time.perf_counter() - t0,
        "epoch_s_median": float(np.median(epoch_times)) if epoch_times else None,
        "epoch_s": epoch_times,
        "setup_s": {"folds": t_folds - t0, "stack": t_stack - t_folds},
        "units": F,
        "arm": "per-step",
        "devices": n_groups,
        "step_ms_median": float(np.median(step_ms)) if step_ms else None,
    }
    for k, d in agg.items():
        out[k] = {e: float(np.mean(v)) for e, v in d.items()}
        out[k + "_std"] = {e: float(np.std(v)) for e, v in d.items()}
        out[k + "_all"] = {e: list(map(float, v)) for e, v in d.items()}
    return out
