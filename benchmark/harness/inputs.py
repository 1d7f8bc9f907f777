"""The inputs of a cell, made by the benchmark from --seed and handed
alike to the program and to the plain reference: the fold's topology and
PCA-row tables (fixed by the configuration's topology seed, so every seed
runs the same shapes), the cohort (omics, labels, ages), the folds'
stratified splits, the class weights and the model's weights.

Nothing here imports the port."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

# stream ids: each use of the seed draws from its own generator
DATA, WEIGHTS, REQUESTS, SAMPLE = 1, 2, 3, 4


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch.Generator on ``device`` for one stream of ``seed`` (any
    whole number below 2**60)."""
    if not 0 <= seed < 2 ** 60:
        raise ValueError(f"seed {seed} out of range")
    return torch.Generator(device=device).manual_seed(seed * 8 + stream)


def numpy_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed, stream])


# ---- the fold: make_gbm_scale_setup's cohort topology (copied, numpy only)

def gene_topology(rng, n_genes: int, e_ppi: int, hub_frac: float, community: int):
    """e_ppi gene pairs: 90% banded in communities, the rest from 20 hubs."""
    n_comm = (n_genes + community - 1) // community
    e_local = int(e_ppi * (1 - hub_frac))
    c = rng.randint(0, n_comm, e_local)
    lo = c * community
    s = lo + rng.randint(0, community, e_local)
    d = lo + rng.randint(0, community, e_local)
    keep = (s < n_genes) & (d < n_genes)
    src_g, dst_g = s[keep], d[keep]
    e_hub = e_ppi - len(src_g)
    hubs = rng.choice(n_genes, 20, replace=False)
    hs = hubs[rng.randint(0, 20, e_hub)]
    hd = rng.randint(0, n_genes, e_hub)
    return np.concatenate([src_g, hs]), np.concatenate([dst_g, hd])


def make_fold(fold: dict) -> Dict[str, np.ndarray]:
    """The fold's topology and PCA-row tables from fold["topology_seed"]:
    senders, receivers, edge attr (before self loops), n_nodes, the PCA
    rows' node slot (-1: the last slot), their pathway slot, the MI mask,
    the pathway display order."""
    rng = np.random.RandomState(fold["topology_seed"])
    n_genes = fold["genes"]
    src_g, dst_g = gene_topology(rng, n_genes, fold["ppi_pairs"], fold["hub_frac"],
                                 fold["community"])
    src = [3 * src_g + o for o in range(3)]
    dst = [3 * dst_g + o for o in range(3)]
    genes = rng.choice(n_genes, n_genes // 2, replace=False)
    src += [3 * genes + 1, 3 * genes + 2]
    dst += [3 * genes, 3 * genes]
    send, recv = np.concatenate(src), np.concatenate(dst)
    attr = rng.rand(len(send)).astype(np.float32)
    nodes = 3 * n_genes
    G, P = fold["pca_rows"], fold["pathways"]
    match = rng.randint(-1, nodes, G)
    raw_indice = np.sort(rng.randint(0, 3 * P, G))
    info_mask = (rng.rand(G, 1) < fold["info_keep"]).astype(np.float32)
    reorder = rng.permutation(P)
    return dict(senders=send.astype(np.int64), receivers=recv.astype(np.int64),
                edge_attr=attr, n_nodes=nodes, gene_pca_match=match.astype(np.int64),
                raw_indice=raw_indice.astype(np.int64), info_mask=info_mask,
                reorder=reorder.astype(np.int64), n_pathways=P)


# ---- the cohort

def make_cohort(cohort: dict, n_nodes: int, seed: int, device) -> Dict[str, np.ndarray]:
    """X (P, n_nodes) omics values N(0, 1), drawn on ``device``; Y (P, 2)
    one-hot with cohort["positives"] patients in class 1 (column 1), in a
    seeded order; ages uniform in [age_low, age_high)."""
    g = generator(seed, DATA, device)
    P = cohort["patients"]
    X = torch.randn(P, n_nodes, generator=g, device=device)
    u = torch.rand(P, generator=g, device=device)
    order = torch.randperm(P, generator=g, device=device).cpu().numpy()
    cls = np.zeros(P, np.int64)
    cls[order[: cohort["positives"]]] = 1
    Y = np.eye(2, dtype=np.float32)[cls]
    ages = cohort["age_low"] + (cohort["age_high"] - cohort["age_low"]) * u
    return dict(X=X.cpu().numpy(), Y=Y, ages=ages.cpu().numpy().astype(np.float32))


def stratified_kfold(labels: np.ndarray, n_splits: int, shuffle: bool, seed):
    """sklearn 1.x StratifiedKFold(n_splits, shuffle, random_state).split,
    as its _make_test_folds builds them."""
    y = np.asarray(labels).reshape(-1)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv.reshape(-1)]
    n_classes = len(y_idx)
    rng = np.random.RandomState(seed) if shuffle else None
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        if shuffle:
            rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    idx = np.arange(len(y))
    return [(idx[test_folds != i], idx[test_folds == i]) for i in range(n_splits)]


def fold_split(Y: np.ndarray, cfg: dict, fold_i: int, n_splits: int = 5):
    """(train, valid, test) of outer fold fold_i, as the protocol splits
    them: the outer stratified split gives (tune, test), the first inner
    split of tune gives (train, valid)."""
    labels = (Y[:, 1] > 0.5).astype(np.int64)
    shuffle, seed = bool(cfg.get("split_shaffle", False)), cfg.get("split_seed", 1)
    tune, test = stratified_kfold(labels, n_splits, shuffle, seed)[fold_i]
    tr, va = stratified_kfold(labels[tune], n_splits, shuffle, seed)[0]
    return tune[tr], tune[va], test


def class_weight(Y: np.ndarray, train_idx, power: float = 1.0) -> np.ndarray:
    """(max count / count) ** power per class over the training rows."""
    y = (np.asarray(Y)[:, 1] > 0.5).astype(np.int64)[np.asarray(train_idx)]
    counts = np.maximum(np.array([(y == 0).sum(), (y == 1).sum()], np.float64), 1)
    return ((counts.max() / counts) ** power).astype(np.float32)


# ---- weights

# a trained model's trunk moves its scores as much as the age does; with
# Xavier's 0.02 over 15,405 rows the node embedding would leave the scores
# to the age and the head's biases, and the check blind to the trunk
NODE_EMBEDDING_BOUND = 1.0
# PCA loadings of the ~57 genes of a slot: unit columns, entries ~ 0.13
PCA_BOUND = math.sqrt(3.0 / 57.0)


def weight_bound(name: str, shape: Tuple[int, ...]) -> float:
    """The seeded weights' rule: U(+-1) for the node embedding, PCA_BOUND
    for the learnable PCA, Xavier-uniform for any other matrix or filter
    (fans over the receptive field), 0 for a vector (the biases)."""
    if name == "node_embedding":
        return NODE_EMBEDDING_BOUND
    if name == "learnable_pca_params":
        return PCA_BOUND
    if len(shape) < 2:
        return 0.0
    rf = math.prod(shape[2:]) if len(shape) > 2 else 1
    return math.sqrt(6.0 / ((shape[0] + shape[1]) * rf))


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
                 pca_rows: int, pca_dim: int) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor on device} for the model's leaves, in one uniform
    draw on the device, each leaf scaled to weight_bound; and "pca_seed",
    the fold's PCA seed (init_with_pca: training starts the learnable PCA
    from it), drawn alike."""
    g = generator(seed, WEIGHTS, device)
    sizes = {n: math.prod(s) for n, s in shapes.items()}
    total = sum(sizes.values()) + pca_rows * pca_dim
    u = torch.rand(total, generator=g, device=device).mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for n, s in shapes.items():
        out[n] = u[off:off + sizes[n]].view(s) * weight_bound(n, s)
        off += sizes[n]
    out["pca_seed"] = u[off:].view(pca_rows, pca_dim) * PCA_BOUND
    return out
