"""MiNet, the sparse-masked multi-omics Cox survival network (port of
multilevel_gnn_tpu/models/minet.py: neg_partial_log_likelihood :47-65,
concordance_index :68-82, OmicsNet :93-147 and the sparse-coding helpers
dropout_mask through sparse_func :150-225).

  omics -> gene -> pathway (each a dense product with its weight times a
  fixed biological connection mask) -> hidden -> hidden2 (+ age) -> Cox
  linear risk score, a BatchNorm and relu after each of the four first
  layers, sub-network dropout by node masks handed in (do_m1 over the
  pathway nodes, do_m2 over the hidden ones), in training mode only.

float32 throughout; the masked products are torch.matmul (JAX's are XLA
products, outside any Pallas kernel).  Outside the model registry, as in
JAX: its (x, age, masks) call is not the driver's (batch, ctx).  Parameter
names follow the flax paths: the masked layers keep flax's (in, out)
kernels as omics_kernel / gene_kernel with their biases; pathway, hidden
and hidden2 are Linears; bn1-bn4 are BatchNorms with flax's batch_stats as
buffers (interop.py).  The sparse-coding phase runs on the host in numpy
and scipy between steps, as in JAX; sparse_func takes and returns a
state_dict.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from multilevel_gnn_tpu_torch.core.device import resolve_device
from multilevel_gnn_tpu_torch.nn.basic import BatchNorm, Linear, uniform_, xavier_bound


def neg_partial_log_likelihood(pred, ytime, yevent, eps: float = 1e-8) -> torch.Tensor:
    """Cox negative partial log-likelihood with Breslow ties on the risk-set
    matrix R[i, j] = 1{ytime[j] >= ytime[i]}: -(1 / n_events) sum_i
    yevent_i (pred_i - log sum_j R_ij e^{pred_j}), the log-sum-exp shifted
    by the largest prediction."""
    pred = pred.reshape(-1).float()
    ytime = ytime.reshape(-1)
    yevent = yevent.reshape(-1).float()
    risk = (ytime[None, :] >= ytime[:, None]).float()
    m = pred.max()
    lse = torch.log(risk @ torch.exp(pred - m) + eps) + m
    n_events = torch.clamp(yevent.sum(), min=1.0)
    return -((pred - lse) * yevent).sum() / n_events


def concordance_index(pred, ytime, yevent) -> torch.Tensor:
    """Harrell's c-index over the comparable pairs (i had the event and
    failed strictly before j's time); a tie in prediction counts 1/2."""
    pred = pred.reshape(-1)
    ytime = ytime.reshape(-1)
    yevent = yevent.reshape(-1).float()
    comparable = (ytime[:, None] < ytime[None, :]).float() * yevent[:, None]
    agree = (pred[:, None] > pred[None, :]).float()
    tied = (pred[:, None] == pred[None, :]).float()
    num = ((agree + 0.5 * tied) * comparable).sum()
    return num / torch.clamp(comparable.sum(), min=1.0)


class OmicsNet(nn.Module):
    """The reference omics_net (minet.py:93-147).  forward(x (B, in_nodes),
    age (B,) or (B, 1), gene_mask (gene_nodes, in_nodes), pathway_mask
    (pathway_nodes, gene_nodes), do_m1, do_m2, drop_rate) -> (B, 1) risk;
    training mode (module.train()) uses the batch statistics, moves the
    running ones and applies the dropout masks with 1 / (1 - rate)."""

    def __init__(self, in_nodes: int, gene_nodes: int, pathway_nodes: int,
                 hidden_nodes: Sequence[int] = (64, 16), device="cuda",
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(seed)
        h0, h1 = hidden_nodes

        def kernel(n_in, n_out):
            return uniform_(nn.Parameter(torch.empty(n_in, n_out)), xavier_bound(n_in, n_out), g)

        self.omics_kernel = kernel(in_nodes, gene_nodes)
        self.omics_bias = nn.Parameter(torch.zeros(gene_nodes))
        self.gene_kernel = kernel(gene_nodes, pathway_nodes)
        self.gene_bias = nn.Parameter(torch.zeros(pathway_nodes))
        self.pathway = Linear(pathway_nodes, h0, kernel_init="xavier", generator=g,
                              zero_bias=True)
        self.hidden = Linear(h0, h1, kernel_init="xavier", generator=g, zero_bias=True)
        self.hidden2 = Linear(h1 + 1, 1, use_bias=False, kernel_init="xavier", generator=g)
        for i, n in enumerate((gene_nodes, pathway_nodes, h0, h1), start=1):
            self.add_module(f"bn{i}", BatchNorm(n))
        self.to(resolve_device(device))

    def forward(self, x, age, gene_mask, pathway_mask, do_m1=None, do_m2=None,
                drop_rate: Tuple[float, float] = (0.0, 0.0)) -> torch.Tensor:
        h = x @ (self.omics_kernel * gene_mask.T.float()) + self.omics_bias
        h = torch.relu(self.bn1(h))
        h = h @ (self.gene_kernel * pathway_mask.T.float()) + self.gene_bias
        h = torch.relu(self.bn2(h))
        if self.training and do_m1 is not None:
            h = h * do_m1 / (1.0 - drop_rate[0])
        h = torch.relu(self.bn3(self.pathway(h)))
        if self.training and do_m2 is not None:
            h = h * do_m2 / (1.0 - drop_rate[1])
        h = torch.relu(self.bn4(self.hidden(h)))
        h = torch.cat([h, age.reshape(-1, 1).to(h.dtype)], dim=1)
        return self.hidden2(h)


# ---------------------------------------------------------- sparse coding --
def dropout_mask(rng: np.random.RandomState, n_node: int, drop_p: float) -> np.ndarray:
    """Binary keep-mask of a sub-network (SparseCoding.py:9-24)."""
    return rng.binomial(1, 1.0 - drop_p, size=n_node).astype(np.float32)


def get_threshold(w: np.ndarray, mask: np.ndarray, sparsity: float) -> float:
    """The cutoff that keeps (100 - sparsity)% of the masked |w|."""
    pos = np.abs(w[mask.astype(bool)])
    top_k = int(np.ceil(pos.size * (100.0 - sparsity) * 0.01))
    top_k = max(min(top_k, pos.size), 1)
    return float(np.sort(pos)[::-1][top_k - 1])


def soft_threshold(w: np.ndarray, th: float) -> np.ndarray:
    """sign(w) * max(|w| - th, 0)."""
    return np.sign(w) * np.clip(np.abs(w) - th, 0.0, None)


def get_sparse_weight(w: np.ndarray, mask: np.ndarray, sparsity: float) -> np.ndarray:
    return soft_threshold(w, get_threshold(w, mask, sparsity))


def get_best_sparsity(sparse_set, loss_set) -> float:
    """The argmin of a cubic interpolation of loss over the sparsity levels,
    on a 100-point grid (scipy's interp1d)."""
    from scipy.interpolate import interp1d

    sparse_set = np.asarray(sparse_set, dtype=np.float64)
    loss_set = np.asarray(loss_set, dtype=np.float64)
    order = np.argsort(sparse_set)
    f = interp1d(sparse_set[order], loss_set[order], kind="cubic")
    grid = np.linspace(sparse_set.min(), sparse_set.max(), 100)
    return float(grid[np.argmin(f(grid))])


def small_net_mask(w: np.ndarray, m_in: np.ndarray, m_out: np.ndarray) -> np.ndarray:
    """The weights of an (in, out) kernel inside the selected sub-network:
    outer(m_in, m_out) as bool."""
    return (np.asarray(m_in).reshape(-1, 1) * np.asarray(m_out).reshape(1, -1)
            ).astype(bool) & np.ones_like(w, dtype=bool)


def sparse_func(state: Dict[str, torch.Tensor], loss_of_params: Callable, do_m1, do_m2,
                do_m3, sparse_set=(99.0, 74.25, 49.5, 24.75, 0.0)) -> Dict[str, torch.Tensor]:
    """The sparse-coding phase (SparseCoding.sparse_func:89-130) on an
    OmicsNet state_dict: for pathway.weight (over do_m1 x do_m2) and then
    hidden.weight (do_m2 x do_m3), score each sparsity level of the active
    block with loss_of_params(candidate state), pick the interpolated best
    and soft-threshold the block.  Returns a new state_dict; ``state`` is
    not changed."""
    state = {k: v.detach().clone() for k, v in state.items()}

    def update(name, m_in, m_out):
        key = f"{name}.weight"
        w = state[key].cpu().numpy().T  # (in, out), as JAX thresholds it
        active = small_net_mask(w, m_in, m_out)
        if not active.any():
            return
        losses = []
        for s in sparse_set:
            trial = dict(state)
            trial[key] = _weight_like(get_sparse_weight(w, active, s), state[key])
            losses.append(float(loss_of_params(trial)))
        best = get_best_sparsity(sparse_set, losses)
        sparse_w = soft_threshold(w, get_threshold(w, active, best))
        state[key] = _weight_like(np.where(active, sparse_w, w), state[key])

    update("pathway", do_m1, do_m2)
    update("hidden", do_m2, do_m3)
    return state


def _weight_like(w_in_out: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_in_out.T.astype(np.float32))).to(like.device)
