"""Batching, evaluation, the fold trainer and the CV protocol (port of
multilevel_gnn_tpu/train/driver.py: stratified_kfold :43, epoch_plan :70,
iter_batches :126 in eval order, FoldResult :156, evaluate :167,
fold_setup :206, run_fold :243-739 on a prepared fold, run_experiment
:794-962; and Cohort.class_weight, data/cohort.py:823-828).

A ragged last batch is padded by repeating its last row, with sample_mask
False on the padding rows, so every batch has the same shape.  The host
RNG (np.random.RandomState) is consumed in exactly the JAX driver's order,
so both draw the same batches.  run_fold gathers each training batch on
the device from a per-epoch plan copied there once (as the JAX driver's
epoch scan does), so the host never waits for the card inside an epoch.

Left out of run_fold and run_experiment: the mesh, checkpoints and resume,
pretraining and pretrained transfer, warm_only, the deepergcn / pathcnn
branches, and epoch_scan / fold_scan, which only change how JAX dispatches
the same steps.  stratified_kfold reproduces sklearn 1.9's StratifiedKFold
in numpy (the GPU hosts have no sklearn).
"""
from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from multilevel_gnn_tpu_torch.core.batch import Batch, FoldContext
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN, seed_pca_params
from multilevel_gnn_tpu_torch.train import metrics as M
from multilevel_gnn_tpu_torch.train.step import eval_step, make_optimizer, train_step


def stratified_kfold(labels: np.ndarray, n_splits: int, shuffle: bool, seed):
    """[(train_idx, test_idx)] of sklearn's StratifiedKFold(n_splits,
    shuffle, random_state=seed if shuffle else None).split(idx, labels),
    as sklearn 1.9's _make_test_folds builds them: classes encoded in order
    of first appearance, each fold's share of a class from a bincount over
    the sorted codes taken every n_splits-th, and each class's fold list
    shuffled by one RandomState(seed) in class order."""
    y = np.asarray(labels).reshape(-1)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv.reshape(-1)]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError(
            f"n_splits={n_splits} cannot be greater than the number of "
            "members in each class."
        )
    rng = np.random.RandomState(seed) if shuffle else None
    y_order = np.sort(y_encoded)
    allocation = np.asarray([
        np.bincount(y_order[i::n_splits], minlength=n_classes)
        for i in range(n_splits)
    ])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        if shuffle:
            rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    idx = np.arange(len(y))
    return [(idx[test_folds != i], idx[test_folds == i]) for i in range(n_splits)]


def epoch_plan(
    X, idxs, batch_size: int,
    rng: Optional[np.random.RandomState] = None,
    shuffle: bool = False,
    drop_last: bool = False,
    sampler_weights: Optional[np.ndarray] = None,
    variation_aug: Optional[dict] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]]:
    """Yields (take (B,) rows, sample_mask (B,) bool, mult (B, ...) or
    None) per batch, as driver.py:70: a WeightedRandomSampler draw with
    replacement when sampler_weights is given, else a permutation when
    shuffle, else idxs in order; drop_last drops a ragged tail;
    variation_aug {prob, range} multiplies each hit row by U(1-range,
    1+range), cnv slots (slot % 3 == 1) exempt.  rng may be None only when
    nothing is drawn."""
    idxs = np.asarray(idxs)
    if sampler_weights is not None:
        num_samples = batch_size * math.ceil(len(idxs) / batch_size)
        p = sampler_weights / sampler_weights.sum()
        sel = idxs[rng.choice(len(idxs), size=num_samples, replace=True, p=p)]
    elif shuffle:
        sel = idxs[rng.permutation(len(idxs))]
    else:
        sel = idxs
    n = len(sel)
    stop = (n // batch_size) * batch_size if drop_last else n
    for s in range(0, stop, batch_size):
        chunk = sel[s : s + batch_size]
        b = len(chunk)
        pad = batch_size - b
        take = np.concatenate([chunk, np.repeat(chunk[-1:], pad)]) if pad else chunk
        mult = None
        if variation_aug is not None:
            shape = (len(take),) + X.shape[1:]
            mult = np.ones(shape, X.dtype)
            hit = rng.rand(len(take)) < variation_aug["prob"]
            r = variation_aug["range"]
            noise = rng.uniform(1 - r, 1 + r, shape).astype(X.dtype)
            if X.ndim == 2:
                noise[:, 1::3] = 1.0
            else:
                noise[..., 1] = 1.0
            mult[hit] = noise[hit]
        yield take, np.concatenate([np.ones(b, bool), np.zeros(pad, bool)]), mult


def iter_batches(X, Y, ages, idxs, batch_size: int, device) -> Iterator[Batch]:
    """Batches of host arrays X (P, NODES), Y (P, 2), ages (P,) on device,
    in the order of idxs (the eval order; run_fold gathers training
    batches on the device from epoch_plan's draws instead)."""
    dev = torch.device(device)
    for take, mask, _ in epoch_plan(X, idxs, batch_size):
        yield Batch(
            x=torch.as_tensor(np.asarray(X[take], np.float32)).to(dev),
            y=torch.as_tensor(np.asarray(Y[take], np.float32)).to(dev),
            age=torch.as_tensor(np.asarray(ages[take], np.float32)).to(dev),
            sample_mask=torch.as_tensor(mask).to(dev),
        )


def evaluate(model, ctx: FoldContext, X, Y, ages, idxs, batch_size: int):
    """Score idxs in order; returns (auc, acc, y_true, score0, mean loss)
    like the JAX driver's evaluate."""
    preds, losses = [], []
    for batch in iter_batches(X, Y, ages, idxs, batch_size, ctx.device):
        pred, loss = eval_step(model, batch, ctx)
        m = batch.sample_mask.cpu().numpy()
        preds.append(pred.float().cpu().numpy()[m])
        losses.append(float(loss))
    pred = np.concatenate(preds)
    auc, acc, y_true, score0 = M.eval_scores(np.asarray(Y)[idxs], pred)
    return auc, acc, y_true, score0, float(np.mean(losses))


def class_weight(Y: np.ndarray, train_idx, weight_power: float = 1.0) -> np.ndarray:
    """(max_count / count) ** weight_power per class over the training rows
    (Cohort.class_weight, data/cohort.py:823-828); class 1 = Y[:, 1] > 0.5."""
    y = (np.asarray(Y)[:, 1] > 0.5).astype(np.int64)[np.asarray(train_idx)]
    counts = np.array([(y == 0).sum(), (y == 1).sum()], np.float64)
    counts = np.maximum(counts, 1)
    return (counts.max() / counts) ** weight_power


def _new_model(cfg: Config, ctx: FoldContext, seed: int) -> MultilevelGNN:
    """A fold's model with its initial parameters drawn from ``seed`` (the
    tests replace this to start from the JAX package's parameters)."""
    return MultilevelGNN(cfg, ctx.graph.n_nodes, ctx.num_pca_rows,
                         device=ctx.device, seed=seed)


@dataclasses.dataclass
class FoldResult:
    """driver.py:156-164, plus what the port's callers read per epoch:
    (valid auc, valid acc, valid loss) per epoch, each training step's loss,
    and each training step's device ms (CUDA events; empty on the CPU)."""

    y_true: np.ndarray
    epoch_pred: Dict[int, np.ndarray]
    epoch_pred_by_loss: Dict[int, np.ndarray]
    epoch_pred_by_epoch: Dict[int, np.ndarray]
    epoch_times: List[float] = dataclasses.field(default_factory=list)
    epoch_valid: List[Tuple[float, float, float]] = dataclasses.field(default_factory=list)
    step_losses: List[float] = dataclasses.field(default_factory=list)
    step_ms: List[float] = dataclasses.field(default_factory=list)


def run_fold(
    cfg: Config,
    ctx: FoldContext,
    X: np.ndarray,
    Y: np.ndarray,
    ages: np.ndarray,
    train_idx,
    valid_idx,
    test_idx,
    fold_class_weight: np.ndarray,
    check_epochs: List[int],
    model=None,
    run_i: int = 0,
    fold_i: int = 0,
) -> FoldResult:
    """Train one prepared fold for cfg.epochs and score it (driver.py:243-739,
    per-step path), with the seeds of (run_i, fold_i).

    ctx: the fold context on its device; X (P, NODES), Y (P, 2), ages (P,)
    host arrays; fold_class_weight: (2,) class_weight of the training rows.
    model: a MultilevelGNN with its initial parameters, or None to build
    one from the fold seed.  Per epoch: the training steps, then evaluate on
    valid and test; best-by-valid-AUC and best-by-valid-loss test scores
    are kept, and recorded at each check epoch (with the current epoch's
    scores as the fallback when no improvement was seen)."""
    dev = ctx.device
    seed = cfg.seed * 10_000 + run_i * 100 + fold_i  # driver.py:317
    if model is None:
        model = _new_model(cfg, ctx, seed)
    if cfg.init_with_pca and ctx.pca_seed is not None:
        seed_pca_params(model, ctx.pca_seed)
    optimizer = make_optimizer(
        model, cfg, max(len(train_idx) // cfg.batch_size, 1)
    )
    generator = torch.Generator(device=dev).manual_seed(seed)
    cw = torch.as_tensor(np.asarray(fold_class_weight, np.float32)).to(dev)
    sampler_weights = None
    if cfg.class_sample:
        labels = (np.asarray(Y)[:, 1] > 0.5).astype(np.int64)[np.asarray(train_idx)]
        sampler_weights = np.asarray(fold_class_weight)[labels]
    np_rng = np.random.RandomState(cfg.seed + 1000 * run_i + fold_i)  # :361
    shuffle = not cfg.class_sample
    drop_last = not (cfg.class_sample or cfg.weighted_loss or cfg.batch_weighted_loss)
    variation = (
        {"prob": cfg.random_variation_prob, "range": cfg.random_range}
        if cfg.random_variation_aug
        else None
    )
    data = {
        "x": torch.as_tensor(np.asarray(X, np.float32)).to(dev),
        "y": torch.as_tensor(np.asarray(Y, np.float32)).to(dev),
        "age": torch.as_tensor(np.asarray(ages, np.float32)).to(dev),
    }
    timed = dev.type == "cuda"
    results = dict(highest_valid=-1.0, highest_valid_loss=100.0, result_y=None,
                   result_y_by_loss=None, epoch={}, epoch_by_loss={},
                   epoch_by_epoch={})
    out = FoldResult(None, {}, {}, {})

    def record(epoch, valid_auc, valid_acc, valid_loss, test_score):
        """_record_epoch, driver.py:460-485."""
        valid_eval = valid_auc if cfg.metrics == "auc" else valid_acc
        if valid_loss < results["highest_valid_loss"]:
            results["highest_valid_loss"] = valid_loss
            results["result_y_by_loss"] = test_score
        if valid_eval > results["highest_valid"]:
            results["highest_valid"] = valid_eval
            results["result_y"] = test_score
        if epoch in check_epochs:
            for key, best in (("epoch", "result_y"), ("epoch_by_loss", "result_y_by_loss")):
                results[key][epoch] = (
                    results[best] if results[best] is not None else test_score
                )
            results["epoch_by_epoch"][epoch] = test_score

    for epoch in range(1, cfg.epochs + 1):
        t0 = time.perf_counter()
        plan = list(epoch_plan(X, train_idx, cfg.batch_size, np_rng, shuffle,
                               drop_last, sampler_weights, variation))
        losses, events = [], []
        if plan:
            # one host-to-device copy of the epoch's plan; rows gathered there
            takes = torch.as_tensor(np.stack([p[0] for p in plan])).to(dev)
            masks = torch.as_tensor(np.stack([p[1] for p in plan])).to(dev)
            mults = (
                torch.as_tensor(np.stack([p[2] for p in plan])).to(dev)
                if variation is not None else None
            )
            for s in range(len(plan)):
                take = takes[s]
                x = data["x"].index_select(0, take)
                batch = Batch(
                    x=x * mults[s] if mults is not None else x,
                    y=data["y"].index_select(0, take),
                    age=data["age"].index_select(0, take),
                    sample_mask=masks[s],
                )
                if timed:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                losses.append(train_step(model, optimizer, batch, ctx, cw, generator))
                if timed:
                    ev[1].record()
                    events.append(ev)
            out.step_losses += [float(v) for v in torch.stack(losses).cpu()]
            out.step_ms += [a.elapsed_time(b) for a, b in events]
        valid_auc, valid_acc, _, _, valid_loss = evaluate(
            model, ctx, X, Y, ages, valid_idx, cfg.batch_size
        )
        _, _, out.y_true, test_score, _ = evaluate(
            model, ctx, X, Y, ages, test_idx, cfg.batch_size
        )
        record(epoch, valid_auc, valid_acc, valid_loss, test_score)
        out.epoch_valid.append((valid_auc, valid_acc, valid_loss))
        out.epoch_times.append(time.perf_counter() - t0)
    out.epoch_pred = {e: results["epoch"][e] for e in check_epochs}
    out.epoch_pred_by_loss = {e: results["epoch_by_loss"][e] for e in check_epochs}
    out.epoch_pred_by_epoch = {e: results["epoch_by_epoch"][e] for e in check_epochs}
    return out


def fold_setup(cfg: Config, cohort, train_idx, fold_i: int, device="cuda"):
    """The per-fold derivation shared by training and prediction
    (driver.py:206-240, the multilevel_gnn branch): Cohort.fold on
    ``device`` and the config's node count.  Returns (cfg, fold, X)."""
    if cfg.model != "multilevel_gnn":
        raise NotImplementedError(f"model {cfg.model!r} is not ported (multilevel_gnn is)")
    fold = cohort.fold(np.asarray(train_idx), fold_i, device=device)
    return cfg.replace(node_num=cohort.num_nodes // 3), fold, cohort.X


class _Prefetcher:
    """One daemon worker thread that derives folds ahead of training
    (driver.py:742-791): a KeyboardInterrupt mid-experiment does not wait
    for an in-flight derivation."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._run, daemon=True, name="fold-prefetch").start()

    def submit(self, fn, *args):
        done, box = threading.Event(), {}
        self._q.put((fn, args, done, box))

        def result():
            done.wait()
            if "e" in box:
                raise box["e"]
            return box["r"]

        return result

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, done, box = item
            try:
                box["r"] = fn(*args)
            except BaseException as e:  # raised again by result()
                box["e"] = e
            done.set()

    def shutdown(self):
        self._q.put(None)


def run_experiment(cfg: Config, cohort, device="cuda") -> Dict:
    """The num_run x 5-fold protocol with pooled check-epoch scoring
    (driver.py:794-962).

    Per run, the outer stratified 5-fold split gives (tune, test); the first
    inner split of tune gives (train, valid).  Every run derives the same
    splits, so each fold's derivation (MI mask, PCA seeds, edges, graph) is
    made once and kept; with cfg.fold_prefetch the next fold's derivation
    runs on a worker thread while the current fold trains.  At each check
    epoch (every 5th, or the last) the test scores of the five folds are
    pooled into one AUC and ACC per run, for the best-by-valid-AUC
    ("auc", "acc"), best-by-valid-loss ("*_by_loss") and current-epoch
    ("*_by_epoch") snapshots; the result holds their mean over runs, their
    std (``*_std``) and every run's value (``*_all``), keyed by epoch.
    ``folds`` lists each trained fold's derivation seconds by stage, its
    median device ms per train step (CUDA only) and host s per epoch."""
    labels = cohort.labels()
    check_epochs = list(range(5, cfg.epochs + 1, 5)) or [cfg.epochs]
    agg = {
        k: {e: [] for e in check_epochs}
        for k in ("auc", "auc_by_loss", "auc_by_epoch", "acc", "acc_by_loss",
                  "acc_by_epoch")
    }
    t0 = time.perf_counter()

    def fold_indices(outer, fold_i):
        tune, test_idx = outer[fold_i]
        tr, va = stratified_kfold(labels[tune], 5, cfg.split_shaffle, cfg.split_seed)[0]
        return tune[tr], tune[va], test_idx

    setup_cache: Dict = {}
    pending: Dict = {}
    prefetcher = _Prefetcher() if cfg.fold_prefetch else None

    def setup(fold_i, train_idx):
        t = time.perf_counter()
        out = fold_setup(cfg, cohort, train_idx, fold_i, device)
        return out, time.perf_counter() - t

    def get_setup(fold_i, train_idx):
        k = (fold_i, np.asarray(train_idx).tobytes())
        if k not in setup_cache:
            fut = pending.pop(k, None)
            setup_cache[k] = fut() if fut is not None else setup(fold_i, train_idx)
        return setup_cache[k]

    def prefetch(fold_i, train_idx):
        k = (fold_i, np.asarray(train_idx).tobytes())
        if prefetcher is not None and k not in setup_cache and k not in pending:
            pending[k] = prefetcher.submit(setup, fold_i, train_idx)

    folds_info = []
    all_epoch_times: List[float] = []
    try:
        for run_i in range(cfg.num_run):
            outer = stratified_kfold(labels, 5, cfg.split_shaffle, cfg.split_seed)
            fold_results: List[FoldResult] = []
            for fold_i in range(len(outer)):
                train_idx, valid_idx, test_idx = fold_indices(outer, fold_i)
                (fcfg, fold, X), setup_s = get_setup(fold_i, train_idx)
                if fold_i + 1 < len(outer):
                    prefetch(fold_i + 1, fold_indices(outer, fold_i + 1)[0])
                fr = run_fold(
                    fcfg.replace(pathway_num=cohort.n_pathways), fold.ctx, X,
                    cohort.Y, cohort.ages, train_idx, valid_idx, test_idx,
                    fold.class_weight, check_epochs, run_i=run_i, fold_i=fold_i,
                )
                fold_results.append(fr)
                all_epoch_times += fr.epoch_times
                folds_info.append({
                    "run": run_i, "fold": fold_i, "setup_s": setup_s,
                    "setup_stage_s": fold.seconds, "edges": fold.edge_count,
                    "windowed": fold.ctx.graph.winplan is not None,
                    "step_ms_median": float(np.median(fr.step_ms)) if fr.step_ms else None,
                    "epoch_s": fr.epoch_times,
                })
            y = np.concatenate([fr.y_true for fr in fold_results])
            for e in check_epochs:
                for key, attr in (("auc", "epoch_pred"),
                                  ("auc_by_loss", "epoch_pred_by_loss"),
                                  ("auc_by_epoch", "epoch_pred_by_epoch")):
                    pred = np.concatenate([getattr(fr, attr)[e] for fr in fold_results])
                    agg[key][e].append(M.roc_auc(y, pred))
                    agg[key.replace("auc", "acc")][e].append(M.accuracy(y, pred > 0.5))
    finally:
        if prefetcher is not None:
            prefetcher.shutdown()
    out = {
        "check_epochs": check_epochs,
        "wall_time_s": time.perf_counter() - t0,
        "epoch_s_median": float(np.median(all_epoch_times)) if all_epoch_times else None,
        "folds": folds_info,
    }
    for k, d in agg.items():
        out[k] = {e: float(np.mean(v)) for e, v in d.items()}
        out[k + "_std"] = {e: float(np.std(v)) for e, v in d.items()}
        out[k + "_all"] = {e: list(map(float, v)) for e, v in d.items()}
    return out
