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

Checkpoints (train/checkpoint.py) go under ckpt_dir/run{r}_fold{f}/ every
cfg.ckpt_every epochs (at the fold's last epoch when 0), keeping the newest
cfg.ckpt_keep; a finished fold's FoldResult is saved as
ckpt_dir/result_run{r}_fold{f}.npy, and resume=True loads finished folds
and resumes an unfinished one at its latest complete step.
run_experiment(pretrain=...) first pretrains an AE / VAE / VQ-VAE encoder
on the cohort (train/pretrain.py) and run_fold copies its parameters into
every fold's model after the PCA seeding.  With cfg.mesh_data_axis x
cfg.mesh_model_axis > 1, run_experiment runs on the ('data', 'model') mesh
of the process group's ranks (parallel/mesh.py; driver.py:284-355,
647-690): each rank takes its rows of every batch and its block of the
fold graph's edges (with cfg.halo_exchange and more than one model rank,
the halo partition of parallel/halo.py for sum and mean), the ranks'
parameters stay equal, evaluate gathers the predictions over the data
group, and rank 0 alone writes checkpoints and fold results.  Left out of
run_fold and run_experiment: warm_only, and epoch_scan / fold_scan, which
only change how JAX dispatches the same steps.  DeeperGCN's folds carry
the pathway node attrs as each batch's raw_data, and PathCNN's its raw
values or PCA attrs (fold_setup's FoldData.raw).
stratified_kfold reproduces sklearn 1.9's StratifiedKFold in numpy (the
GPU hosts have no sklearn).
"""
from __future__ import annotations

import dataclasses
import math
import os
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multilevel_gnn_tpu_torch.core.batch import Batch, FoldContext
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.models import get_model
from multilevel_gnn_tpu_torch.models.deepergcn import DeeperGCN, apply_init_weight
from multilevel_gnn_tpu_torch.models.multiomix import MultiOmixGCN
from multilevel_gnn_tpu_torch.models.multilevel_gnn import seed_pca_params
from multilevel_gnn_tpu_torch.parallel.mesh import maybe_make_mesh, replicate
from multilevel_gnn_tpu_torch.train import checkpoint as C
from multilevel_gnn_tpu_torch.train import metrics as M
from multilevel_gnn_tpu_torch.train.step import eval_step, make_optimizer, train_step
from multilevel_gnn_tpu_torch.utils.profiling import count, span


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


def fold_indices(labels: np.ndarray, cfg: Config, fold_i: int):
    """(train, valid, test) patient indices of outer fold fold_i
    (driver.py:824-830): the outer stratified 5-fold split gives (tune,
    test); the first inner split of tune gives (train, valid)."""
    tune, test_idx = stratified_kfold(labels, 5, cfg.split_shaffle, cfg.split_seed)[fold_i]
    tr, va = stratified_kfold(labels[tune], 5, cfg.split_shaffle, cfg.split_seed)[0]
    return tune[tr], tune[va], test_idx


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


def iter_batches(X, Y, ages, idxs, batch_size: int, device, raw=None) -> Iterator[Batch]:
    """Batches of host arrays X (P, NODES) or (P, N, omics), Y (P, 2),
    ages (P,) and raw (P, ...) or None on device, in the order of idxs
    (the eval order; run_fold gathers training batches on the device from
    epoch_plan's draws instead)."""
    dev = torch.device(device)

    def on(a, take):
        return torch.as_tensor(np.asarray(a[take], np.float32)).to(dev)

    for take, mask, _ in epoch_plan(X, idxs, batch_size):
        with span("eval.batch_in"):
            batch = Batch(
                x=on(X, take), y=on(Y, take), age=on(ages, take),
                sample_mask=torch.as_tensor(mask).to(dev),
                raw_data=on(raw, take) if raw is not None else None,
            )
        yield batch


def evaluate(model, ctx: FoldContext, X, Y, ages, idxs, batch_size: int, raw=None,
             mesh=None):
    """Score idxs in order; returns (auc, acc, y_true, score0, mean loss)
    like the JAX driver's evaluate.  On a mesh, ctx is the rank's and the
    predictions are gathered over the data group (equal on every rank)."""
    with span("fold.evaluate"):
        preds, losses = [], []
        for batch in iter_batches(X, Y, ages, idxs, batch_size, ctx.device, raw):
            pred, loss = eval_step(model, batch, ctx, mesh)
            with span("eval.readback"):
                m = batch.sample_mask.cpu().numpy()
                preds.append(pred.float().cpu().numpy()[m])
                losses.append(float(loss))
                count("host_syncs", 3)  # the three read-backs above
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


def _new_model(cfg: Config, ctx: FoldContext, seed: int,
               init_weight: bool = True) -> torch.nn.Module:
    """A fold's model of cfg.model with its initial parameters drawn from
    ``seed``; DeeperGCN's then re-initialised by apply_init_weight under
    all_init / head_init, as driver.py:327-334 does, unless init_weight is
    False (fold-parallel CV, whose JAX counterpart leaves the re-init out,
    fold_parallel.py:170-192).  The tests replace this function to start
    from the JAX package's parameters."""
    cls = get_model(cfg.model)
    if cls is MultiOmixGCN:
        return cls(cfg, device=ctx.device, seed=seed)
    if cls is not DeeperGCN:
        return cls(cfg, ctx.graph.n_nodes, ctx.num_pca_rows, device=ctx.device, seed=seed)
    model = DeeperGCN(cfg, device=ctx.device, seed=seed)
    if init_weight and (cfg.all_init or cfg.head_init):
        apply_init_weight(model, torch.Generator().manual_seed(seed + 7),
                          head_only=not cfg.all_init)
    return model


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
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    interrupt_after: Optional[List[int]] = None,
    raw: Optional[np.ndarray] = None,
    pretrained_params: Optional[Dict[str, torch.Tensor]] = None,
    mesh=None,
) -> FoldResult:
    """Train one prepared fold for cfg.epochs and score it (driver.py:243-739,
    per-step path), with the seeds of (run_i, fold_i).

    ctx: the fold context on its device; X (P, NODES) or (P, N, omics),
    Y (P, 2), ages (P,) and raw (P, ...) or None (the batches' raw_data)
    host arrays; fold_class_weight: (2,) class_weight of the training rows.
    model: a model of cfg.model with its initial parameters, or None to
    build one from the fold seed.  Per epoch: the training steps, then
    evaluate on valid and test; best-by-valid-AUC and best-by-valid-loss test scores
    are kept, and recorded at each check epoch (with the current epoch's
    scores as the fallback when no improvement was seen).

    ckpt_dir: checkpoints under ckpt_dir/run{run_i}_fold{fold_i}/ (module
    docstring); resume: start from its latest complete step.  The lists of
    a resumed fold's FoldResult hold the epochs run in this call.
    interrupt_after: [n], a test hook counted down once per epoch across
    calls; at 0 it checkpoints and raises KeyboardInterrupt.
    pretrained_params: a pretrained model's state_dict, copied in after the
    PCA seeding so its PCA params win (driver.py:334-343).
    mesh: a parallel.mesh.Mesh (run_experiment's); ctx is then the whole
    fold's, sharded here."""
    dev = ctx.device
    if mesh is not None:
        ctx = mesh_ctx(cfg, ctx, mesh)
    seed = cfg.seed * 10_000 + run_i * 100 + fold_i  # driver.py:317
    if model is None:
        model = _new_model(cfg, ctx, seed)
    if cfg.init_with_pca and ctx.pca_seed is not None:
        seed_pca_params(model, ctx.pca_seed)
    if pretrained_params is not None:
        from multilevel_gnn_tpu_torch.train.pretrain import transfer_pretrained

        transfer_pretrained(pretrained_params, model)
    if mesh is not None:
        replicate(model, mesh)
    optimizer = make_optimizer(
        model, cfg, max(len(train_idx) // cfg.batch_size, 1)
    )
    writer = mesh is None or mesh.rank == 0
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
    if raw is not None:
        data["raw"] = torch.as_tensor(np.asarray(raw, np.float32)).to(dev)
    timed = dev.type == "cuda"
    results = dict(highest_valid=-1.0, highest_valid_loss=100.0, result_y=None,
                   result_y_by_loss=None, epoch={}, epoch_by_loss={},
                   epoch_by_epoch={})
    out = FoldResult(None, {}, {}, {})
    step_i, start_epoch = 0, 1
    tag_dir = (os.path.join(ckpt_dir, f"run{run_i}_fold{fold_i}")
               if ckpt_dir is not None else None)
    if tag_dir is not None and resume:
        last = C.latest_resumable_step(tag_dir)
        if last is not None:
            tree, _ = C.load_checkpoint(tag_dir, last)
            model.load_state_dict(tree["model"])
            optimizer.load_state_dict(tree["optimizer"])
            generator.set_state(tree["generator"])
            host = C.load_host_state(tag_dir, last)
            results = host["results"]
            out.y_true = host["y_true_test"]
            step_i = host["step_i"]
            np_rng.set_state(host["np_rng_state"])
            start_epoch = last + 1

    def save(epoch):
        """_save_fold_ckpt, driver.py:487-514."""
        C.save_checkpoint(tag_dir, model, optimizer, generator,
                          {"run": run_i, "fold": fold_i, "epoch": epoch}, step=epoch)
        C.save_host_state(tag_dir, epoch, {
            "results": results, "y_true_test": out.y_true, "step_i": step_i,
            "np_rng_state": np_rng.get_state()})
        C.prune_old_steps(tag_dir, cfg.ckpt_keep)

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

    for epoch in range(start_epoch, cfg.epochs + 1):
        with span("fold.epoch"):
            t0 = time.perf_counter()
            with span("fold.plan"):
                plan = list(epoch_plan(X, train_idx, cfg.batch_size, np_rng, shuffle,
                                       drop_last, sampler_weights, variation))
                if plan:
                    # one host-to-device copy of the epoch's plan; rows gathered there
                    takes = torch.as_tensor(np.stack([p[0] for p in plan])).to(dev)
                    masks = torch.as_tensor(np.stack([p[1] for p in plan])).to(dev)
                    mults = (
                        torch.as_tensor(np.stack([p[2] for p in plan])).to(dev)
                        if variation is not None else None
                    )
            losses, events = [], []
            if plan:
                for s in range(len(plan)):
                    take = takes[s]
                    x = data["x"].index_select(0, take)
                    batch = Batch(
                        x=x * mults[s] if mults is not None else x,
                        y=data["y"].index_select(0, take),
                        age=data["age"].index_select(0, take),
                        sample_mask=masks[s],
                        raw_data=data["raw"].index_select(0, take) if raw is not None else None,
                    )
                    if timed:
                        ev = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                        ev[0].record()
                    losses.append(train_step(model, optimizer, batch, ctx, cw, generator, mesh))
                    if timed:
                        ev[1].record()
                        events.append(ev)
                with span("fold.loss_readback"):
                    out.step_losses += [float(v) for v in torch.stack(losses).cpu()]
                    out.step_ms += [a.elapsed_time(b) for a, b in events]
                    count("host_syncs")
                step_i += len(plan)
            valid_auc, valid_acc, _, _, valid_loss = evaluate(
                model, ctx, X, Y, ages, valid_idx, cfg.batch_size, raw, mesh
            )
            _, _, out.y_true, test_score, _ = evaluate(
                model, ctx, X, Y, ages, test_idx, cfg.batch_size, raw, mesh
            )
            record(epoch, valid_auc, valid_acc, valid_loss, test_score)
            out.epoch_valid.append((valid_auc, valid_acc, valid_loss))
            out.epoch_times.append(time.perf_counter() - t0)
            interrupt = interrupt_after is not None and interrupt_after[0] == 1
            if writer and tag_dir is not None and (
                (cfg.ckpt_every > 0 and epoch % cfg.ckpt_every == 0)
                or interrupt or (cfg.ckpt_every <= 0 and epoch == cfg.epochs)
            ):
                save(epoch)
            if interrupt and mesh is not None and mesh.size > 1:
                dist.barrier()  # rank 0's checkpoint is whole before any rank stops
            if interrupt_after is not None:
                interrupt_after[0] -= 1
                if interrupt_after[0] <= 0:
                    raise KeyboardInterrupt(
                        f"interrupted at run {run_i} fold {fold_i} epoch {epoch} (test hook)")
    out.epoch_pred = {e: results["epoch"][e] for e in check_epochs}
    out.epoch_pred_by_loss = {e: results["epoch_by_loss"][e] for e in check_epochs}
    out.epoch_pred_by_epoch = {e: results["epoch_by_epoch"][e] for e in check_epochs}
    return out


def mesh_ctx(cfg: Config, ctx: FoldContext, mesh) -> FoldContext:
    """The rank's fold context on the mesh (driver.py:284-311): batch_size
    must split over the data ranks; the rank's edge block (shard_ctx); with
    cfg.halo_exchange and more than one model rank, the halo partition of
    the shard-padded graph (edge_sel indexes it) with the rank's plans
    (windowed interior under cfg.windowed_spmm) on the rank's graph, which
    routes its sum and mean through the halo form (ops/spmm.py)."""
    from multilevel_gnn_tpu_torch.parallel.halo import build_halo_partition
    from multilevel_gnn_tpu_torch.parallel.mesh import padded_graph, shard_ctx

    if cfg.batch_size % mesh.n_data:
        raise AssertionError((cfg.batch_size, mesh.shape))
    sharded = shard_ctx(ctx, mesh)
    if cfg.halo_exchange and mesh.n_model > 1:
        hp = build_halo_partition(padded_graph(ctx.graph, mesh.n_model), mesh.n_model,
                                  windowed=cfg.windowed_spmm)
        rank = hp.for_rank(mesh.model_rank, mesh.model_group, ctx.device, ctx.graph)
        sharded = dataclasses.replace(
            sharded, graph=dataclasses.replace(sharded.graph, halo=rank))
    return sharded


def fold_setup(cfg: Config, cohort, train_idx, fold_i: int, device="cuda"):
    """The per-fold derivation shared by training and prediction
    (driver.py:206-240) on ``device``, with the config's node counts.
    multilevel_gnn and the rest: Cohort.fold, X (P, NODES); for pathcnn,
    fold.raw is the PCA-row values (P, G) in patient order with
    learnable_pca, else the fold's pathway PCA attrs flat, (P, P_w * 3K).
    deepergcn: the gene-level Cohort.deepergcn_fold (whose fold.raw
    carries the pathway node attrs), X (P, N, omics) from
    gene_level_features, node_num = genes + pathway nodes and
    pathway_edge_num = max(the cohort's pathway edges, 1).  Returns (cfg,
    fold, X)."""
    get_model(cfg.model)  # raises for a model the port does not have
    if cfg.model == "deepergcn":
        fold = cohort.deepergcn_fold(np.asarray(train_idx), fold_i, device=device)
        cfg = cfg.replace(pathway_edge_num=max(cohort.pathway_edge_num, 1),
                          node_num=cohort.node_size + cohort.n_pathways)
        return cfg, fold, fold_features(cfg, cohort)
    fold = cohort.fold(np.asarray(train_idx), fold_i, device=device)
    if cfg.model == "pathcnn":
        if cfg.learnable_pca:
            pos = {p: i for i, p in enumerate(cohort.pca_patients)}
            raw = cohort.raw_datas[[pos[p] for p in cohort.patients]]
        else:
            raw = fold.pathway_node_attr.reshape(len(cohort.patients), -1)
        fold = dataclasses.replace(fold, raw=raw.astype(np.float32))
    return cfg.replace(node_num=cohort.num_nodes // 3), fold, fold_features(cfg, cohort)


def fold_features(cfg: Config, cohort) -> np.ndarray:
    """The batches' X of fold_setup, the same for every fold: deepergcn's
    gene_level_features (P, N, omics), else the cohort's X (P, NODES)."""
    return cohort.gene_level_features() if cfg.model == "deepergcn" else cohort.X


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


def run_experiment(
    cfg: Config, cohort, device="cuda", ckpt_dir: Optional[str] = None,
    resume: bool = False, interrupt_after: Optional[List[int]] = None,
    pretrain: Optional[str] = None, pretrain_epochs: Optional[int] = None,
) -> Dict:
    """The num_run x 5-fold protocol with pooled check-epoch scoring
    (driver.py:794-962).

    Per run, fold_indices gives each fold's (train, valid, test).  Every
    run derives the same splits, so each fold's derivation (MI mask, PCA
    seeds, edges, graph) is made once and kept; with cfg.fold_prefetch the
    next fold's derivation runs on a worker thread while the current fold
    trains.  At each check epoch (every 5th, or the last) the test scores
    of the five folds are pooled into one AUC and ACC per run, for the
    best-by-valid-AUC ("auc", "acc"), best-by-valid-loss ("*_by_loss") and
    current-epoch ("*_by_epoch") snapshots; the result holds their mean
    over runs, their std (``*_std``) and every run's value (``*_all``),
    keyed by epoch.  ``folds`` lists each fold's derivation seconds by
    stage, its median device ms per train step (CUDA only) and host s per
    epoch; a fold loaded from its result record has "loaded": True.
    ``epoch_s_median`` is the median host s per epoch over the last run's
    folds, as JAX takes it.

    ckpt_dir / resume / interrupt_after: as run_fold's; each finished
    fold's FoldResult is saved as ckpt_dir/result_run{r}_fold{f}.npy, and
    with resume a fold that has one is loaded instead of trained (the next
    fold's derivation is still prefetched).

    pretrain: 'autoencoder', 'vae', 'mmd_vae' or 'vq_vae': first
    pretrain_autoencoder for pretrain_epochs (cfg.epochs when None), then
    every fold's model starts from its matching parameters
    (driver.py:795-826); on a mesh each rank pretrains alike and rank 0's
    parameters are broadcast.

    On a mesh (cfg.mesh_data_axis x cfg.mesh_model_axis > 1) every rank of
    the process group calls run_experiment with its own device; all return
    the same result, and only rank 0 writes under ckpt_dir."""
    mesh = maybe_make_mesh(cfg)
    pretrained_params = None
    if pretrain is not None:
        from multilevel_gnn_tpu_torch.train.pretrain import pretrain_autoencoder

        pre, _, _, _ = pretrain_autoencoder(
            cfg.replace(slot_sizes=cohort.slot_sizes()), cohort, pretrain,
            epochs=pretrain_epochs, device=device)
        pretrained_params = {k: v.detach().clone() for k, v in pre.state_dict().items()}
        del pre
        if mesh is not None:
            replicate(pretrained_params, mesh)
    labels = cohort.labels()
    check_epochs = list(range(5, cfg.epochs + 1, 5)) or [cfg.epochs]
    agg = {
        k: {e: [] for e in check_epochs}
        for k in ("auc", "auc_by_loss", "auc_by_epoch", "acc", "acc_by_loss",
                  "acc_by_epoch")
    }
    t0 = time.perf_counter()
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
    fold_results: List[FoldResult] = []
    try:
        for run_i in range(cfg.num_run):
            fold_results = []
            for fold_i in range(5):
                train_idx, valid_idx, test_idx = fold_indices(labels, cfg, fold_i)
                done = (os.path.join(ckpt_dir, f"result_run{run_i}_fold{fold_i}.npy")
                        if ckpt_dir is not None else None)
                loaded = resume and done is not None and os.path.exists(done)
                if not loaded:
                    (fcfg, fold, X), setup_s = get_setup(fold_i, train_idx)
                if fold_i + 1 < 5:
                    prefetch(fold_i + 1, fold_indices(labels, cfg, fold_i + 1)[0])
                if loaded:
                    fr = np.load(done, allow_pickle=True).item()
                    info = {"loaded": True}
                else:
                    fr = run_fold(
                        fcfg.replace(pathway_num=cohort.n_pathways), fold.ctx, X,
                        cohort.Y, cohort.ages, train_idx, valid_idx, test_idx,
                        fold.class_weight, check_epochs, run_i=run_i, fold_i=fold_i,
                        ckpt_dir=ckpt_dir, resume=resume,
                        interrupt_after=interrupt_after, raw=fold.raw,
                        pretrained_params=pretrained_params, mesh=mesh,
                    )
                    if done is not None and (mesh is None or mesh.rank == 0):
                        os.makedirs(ckpt_dir, exist_ok=True)
                        with open(f"{done}.tmp", "wb") as f:
                            np.save(f, fr, allow_pickle=True)
                        os.replace(f"{done}.tmp", done)
                    info = {
                        "setup_s": setup_s, "setup_stage_s": fold.seconds,
                        "edges": fold.edge_count,
                        "windowed": fold.ctx.graph.winplan is not None,
                    }
                fold_results.append(fr)
                folds_info.append({
                    "run": run_i, "fold": fold_i, **info,
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
    epoch_times = [t for fr in fold_results for t in fr.epoch_times]
    out = {
        "check_epochs": check_epochs,
        "wall_time_s": time.perf_counter() - t0,
        "epoch_s_median": float(np.median(epoch_times)) if epoch_times else None,
        "folds": folds_info,
    }
    for k, d in agg.items():
        out[k] = {e: float(np.mean(v)) for e, v in d.items()}
        out[k + "_std"] = {e: float(np.std(v)) for e, v in d.items()}
        out[k + "_all"] = {e: list(map(float, v)) for e, v in d.items()}
    return out
