"""The plain reference of the kirc and gbm configurations: MultilevelGNN
with SAGE convolutions, its loss and Adam, in plain PyTorch float32 (TF32
off), written from the model's equations and independent of the port.

    h0[n, b, :]  = x[b, n] * emb[n, :]                      node embedding
    per layer    m[n] = sum_{e: r(e) = n} w_e h[s(e)],  w_e = a_e / indeg(n)
                 h    = leaky_relu([h, m Wr^T] Wn^T + bn, 0.2)
    h            = h * x^T                                  value mask
    xg[g]        = h[row(g)] * [match(g) >= 0]              PCA-row gather
    I[b, c, s, k] = sum_{g: slot(g) = s} xg[g, b, c] P[g, k] * mask(g)
    image        = I as (B, C, P, 3K), pathways reordered
    head         = convs (relu), max-pool, dropout, flatten, [age],
                   relu(Linear), dropout, Linear, softmax

The graph is self-looped here (existing loops removed, one per node with
attribute 1) and the mean weights are worked out here; the program's
plans, windows and derived weights are not read.  precision="fp8" rounds
the trunk's values, weights and SpMM weights to e4m3's 3-bit mantissa
wherever the configuration's bfloat16 trunk rounds to bfloat16: the
control that a lower precision fails the comparison.

Dropout masks are drawn as the port's driver draws them (a generator on
the device seeded cfg.seed * 10000 + run * 100 + fold; each mask a
torch.rand of the value's shape, kept where < 1 - rate), so that the
reference follows the same training steps.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LEAKY_SLOPE = 0.2


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to 4 significant bits (e4m3's mantissa), its range kept."""
    m, e = torch.frexp(t)
    return torch.ldexp(torch.round(m * 16.0) / 16.0, e)


class _CastFp8(torch.autograd.Function):
    """A cast to the lower precision as the trunk's bfloat16 casts behave:
    the value rounded forward, the cotangent rounded backward."""

    @staticmethod
    def forward(t):
        return round_fp8(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g)


def _round(precision: str):
    if precision == "f32":
        return lambda t: t
    if precision == "fp8":
        return _CastFp8.apply
    raise ValueError(precision)


def trunk_dims(cfg: dict) -> List[Tuple[int, int]]:
    emb = cfg["node_embedding_dim"]
    hid, fin = cfg["hidden_channels"], cfg["final_channels"]
    return [(emb, hid)] + [(hid, hid)] * max(cfg["num_layers"] - 2, 0) + [(hid, fin)]


def head_shape(cfg: dict) -> Tuple[int, int, int]:
    """(channels, height, width) of the head's pooled image."""
    ch, h, w = cfg["final_channels"], cfg["pathway_num"], 3 * cfg["pca_dim"]
    for out, k in zip(cfg["conv_channel_list"], cfg["conv_kernel_list"]):
        ch, h, w = out, h + 2 * (k // 2) - k + 1, w + 2 * (k // 2) - k + 1
    return ch, h // cfg["pathway_pool_dim"], w // cfg["pca_pool_dim"]


def param_shapes(cfg: dict, n_nodes: int, pca_rows: int) -> Dict[str, Tuple[int, ...]]:
    """The model's leaves by the port's parameter names."""
    s = {"node_embedding": (n_nodes, cfg["node_embedding_dim"])}
    for i, (cin, cout) in enumerate(trunk_dims(cfg)):
        s[f"gnn_{i}.gconv.lin_r.weight"] = (cout, cin)
        s[f"gnn_{i}.gconv.nn.Linear_0.weight"] = (cout, cin + cout)
        s[f"gnn_{i}.gconv.nn.Linear_0.bias"] = (cout,)
    s["learnable_pca_params"] = (pca_rows, cfg["pca_dim"])
    ch = cfg["final_channels"]
    for i, (out, k) in enumerate(zip(cfg["conv_channel_list"], cfg["conv_kernel_list"])):
        s[f"conv_head.Conv_{i}.weight"] = (out, ch, k, k)
        s[f"conv_head.Conv_{i}.bias"] = (out,)
        ch = out
    c, h, w = head_shape(cfg)
    flat = c * h * w + (1 if cfg.get("use_age", False) else 0)
    s["conv_head.head_0.weight"] = (cfg["head_dim"], flat)
    s["conv_head.head_0.bias"] = (cfg["head_dim"],)
    s["conv_head.head_1.weight"] = (2, cfg["head_dim"])
    s["conv_head.head_1.bias"] = (2,)
    return s


def dropout_seed(cfg: dict, run_i: int = 0, fold_i: int = 0) -> int:
    return cfg.get("seed", 1) * 10_000 + run_i * 100 + fold_i


class Reference:
    """The reference model on one fold.  fold: the benchmark's fold
    tables (inputs.make_fold); device: where it runs."""

    # options this reference follows at these values only
    FIXED = {"model": "multilevel_gnn", "gnn_name": "sage", "gnn_act": "leakyrelu",
             "gnn_last_norm": False, "gnn_mlp_norm": "none", "gnn_dropout": 0.0,
             "input_drop": None, "input_emb_drop": None, "resgnn": False,
             "dense_gnn": False, "repeat_mask": False, "merge_mode": "mult",
             "reduction_method": "linear_projection", "edge_type": "grnboost2",
             "node_embedding": True, "pca_prelinear": False, "only_mrna_pred": False,
             "used_omics": "012", "pca_loss": False, "freeze_pca_weight": False,
             "freeze_node_embedding": False, "class_sample": False,
             "weighted_loss": False, "batch_weighted_loss": False,
             "random_variation_aug": False, "warmup_epochs": 0}

    def __init__(self, cfg: dict, fold: dict, device, precision: str = "f32"):
        odd = {k: cfg.get(k) for k, v in self.FIXED.items() if cfg.get(k, v) != v}
        if odd:
            raise NotImplementedError(f"the reference does not follow {odd}")
        self.cfg, self.dev = cfg, torch.device(device)
        self.q = _round(precision)
        n = fold["n_nodes"]
        send, recv = np.asarray(fold["senders"]), np.asarray(fold["receivers"])
        attr = np.asarray(fold["edge_attr"], np.float32).reshape(-1)
        keep = send != recv
        loop = np.arange(n)
        send = np.concatenate([send[keep], loop])
        recv = np.concatenate([recv[keep], loop])
        attr = np.concatenate([attr[keep], np.ones(n, np.float32)])
        if not cfg.get("weighted_edge", False):
            attr = np.ones_like(attr)
        deg = np.bincount(recv, minlength=n).astype(np.float32)
        t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=self.dev)  # noqa: E731
        self.n_nodes = n
        self.send, self.recv = t(send, torch.int64), t(recv, torch.int64)
        self.w = self.q(t(attr / np.maximum(deg, 1.0)[recv], torch.float32))
        match = np.asarray(fold["gene_pca_match"])
        self.rows = t(np.where(match >= 0, match, n + match), torch.int64)
        self.row_keep = t(match >= 0, torch.float32) if cfg.get("pca_match_mask") else None
        self.slot = t(fold["raw_indice"], torch.int64)
        self.info = t(fold["info_mask"], torch.float32).reshape(-1, 1)
        self.reorder = t(fold["reorder"], torch.int64)
        self.n_pathways = int(fold["n_pathways"])

    # ---- forward

    def _spmm_mean(self, h: torch.Tensor) -> torch.Tensor:
        """(N, B, C) -> (N, B, C) f32: sum over in-edges of w_e h[src]."""
        N = h.shape[0]
        h2 = h.reshape(N, -1)
        out = torch.zeros_like(h2).index_add_(0, self.recv, h2[self.send] * self.w[:, None])
        return out.reshape(h.shape)

    def trunk(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        cfg, q = self.cfg, self.q
        mask = q(x.T)
        h = x.T[..., None] * p["node_embedding"][:, None, :]
        for i in range(len(trunk_dims(cfg))):
            xin = q(h)
            mean = q(self._spmm_mean(xin))
            aggr = q(mean @ q(p[f"gnn_{i}.gconv.lin_r.weight"]).T)
            pre = q(torch.cat([xin, aggr], -1) @ q(p[f"gnn_{i}.gconv.nn.Linear_0.weight"]).T)
            pre = q(pre + q(p[f"gnn_{i}.gconv.nn.Linear_0.bias"]))
            h = q(torch.where(pre >= 0, pre, pre * LEAKY_SLOPE))
        if cfg.get("value_att_mask"):
            h = q(h * mask[..., None])
        return h

    def image(self, p: dict, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        xg = h.float()[self.rows]
        if self.row_keep is not None:
            xg = xg * self.row_keep[:, None, None]
        G, B, C = xg.shape
        pca = p["learnable_pca_params"]
        if cfg.get("mutual_info_mask") or cfg["final_channels"] != 1:
            pca = pca * self.info
        K, S = pca.shape[1], 3 * self.n_pathways
        contrib = xg.reshape(G, B * C, 1) * pca[:, None, :]
        out = torch.zeros(S, B * C, K, device=self.dev).index_add_(0, self.slot, contrib)
        img = out.reshape(S, B, C, K).permute(1, 2, 0, 3).reshape(B, C, self.n_pathways, 3 * K)
        if cfg.get("reorder_pathway"):
            img = img.index_select(2, self.reorder)
        return img

    def head(self, p: dict, img: torch.Tensor, age: torch.Tensor,
             gen: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        h = img
        for i, k in enumerate(cfg["conv_kernel_list"]):
            h = F.relu(F.conv2d(h, p[f"conv_head.Conv_{i}.weight"],
                                p[f"conv_head.Conv_{i}.bias"], padding=k // 2))
        if len(cfg.get("used_omics", "012")) != 3:
            raise NotImplementedError("used_omics other than all three")
        h = F.max_pool2d(h, (cfg["pathway_pool_dim"], cfg["pca_pool_dim"]))
        if gen is not None and cfg.get("feature_drop"):
            h = _dropout(h, 0.25, gen)
        h = h.reshape(h.shape[0], -1)
        if cfg.get("use_age"):
            h = torch.cat([h, age[:, None]], -1)
        h = F.relu(h @ p["conv_head.head_0.weight"].T + p["conv_head.head_0.bias"])
        if gen is not None:
            h = _dropout(h, cfg.get("head_drop_rate", 0.5), gen)
        return torch.softmax(h @ p["conv_head.head_1.weight"].T + p["conv_head.head_1.bias"], -1)

    def forward(self, p: dict, x, age, gen=None) -> torch.Tensor:
        """Probabilities (B, 2); gen: the dropout masks' generator in
        training, None in evaluation."""
        return self.head(p, self.image(p, self.trunk(p, x)), age, gen)

    # ---- losses

    def bce_loss(self, pred, y, mask, weight=None) -> torch.Tensor:
        el = -(y * torch.clamp(torch.log(pred), min=-100.0)
               + (1 - y) * torch.clamp(torch.log(1 - pred), min=-100.0))
        m = mask.float()[:, None]
        if weight is not None:
            el = el * weight[None, :]
        return (el * m).sum() / torch.clamp(m.sum() * el.shape[1], min=1.0)

    def feature_loss(self, p: dict) -> torch.Tensor:
        """pca_indep_loss as the configuration defines it: the mean |cos|
        between PCA columns per pathway slot, of the detached masked
        parameters, with only the last column j of each i added."""
        cfg = self.cfg
        loss = torch.zeros((), device=self.dev)
        if not cfg.get("pca_indep_loss"):
            return loss
        if cfg.get("pca_loss"):
            raise NotImplementedError("pca_loss")
        pca = (p["learnable_pca_params"] * self.info).detach()
        S, K = 3 * self.n_pathways, pca.shape[1]

        def per_slot(v):
            return torch.zeros(S, device=self.dev).index_add_(0, self.slot, v)

        indep, count = torch.zeros((), device=self.dev), 0
        for i in range(K - 1):
            for j in range(i + 1, K):
                count += 1
                mul = per_slot(pca[:, i] * pca[:, j])
                length = torch.sqrt(per_slot(pca[:, i] ** 2) * per_slot(pca[:, j] ** 2))
            indep = indep + torch.mean(torch.abs(mul / (length + 1e-7)))
        return loss + indep / count

    # ---- the two paths the cells drive

    @torch.no_grad()
    def evaluate(self, p: dict, x, y, age) -> Tuple[torch.Tensor, torch.Tensor]:
        """(probabilities, mean BCE loss) of one batch, every row real."""
        pred = self.forward(p, x, age)
        return pred, self.bce_loss(pred, y, torch.ones(len(x), dtype=torch.bool,
                                                       device=self.dev))

    def train(self, p0: dict, batches, class_weight, steps: int, fault: str = ""):
        """``steps`` Adam steps from p0 on batches [(x, y, age, mask)], as the
        configuration trains (lr with its StepLR, betas, eps 1e-8, no
        decay or clip at these settings).  Returns (losses, the first
        step's gradients, the parameters after the last step).
        fault="half_batch": each batch's second half masked out (the mean
        taken over the rest), a control of what the comparison catches."""
        cfg = self.cfg
        if cfg.get("clip_grad") or cfg.get("wd", 0.0) or cfg.get("optimizer", "adam") != "adam":
            raise NotImplementedError("only Adam without clip or decay")
        b1, b2, lr = cfg.get("beta1", 0.9), cfg.get("beta2", 0.999), cfg.get("lr", 1e-4)
        p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        gen = torch.Generator(device=self.dev).manual_seed(dropout_seed(cfg))
        losses, first = [], None
        for t, (x, y, age, mask) in enumerate(batches[:steps], 1):
            if fault == "half_batch":
                mask = mask.clone()
                mask[len(mask) // 2:] = False
            pred = self.forward(p, x, age, gen)
            loss = self.bce_loss(pred, y, mask, class_weight if cfg.get("weight_balance")
                                 else None) + self.feature_loss(p)
            grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
            losses.append(float(loss.detach()))
            grads = [torch.zeros_like(w) if g is None else g for w, g in zip(p.values(), grads)]
            if t == 1:
                first = {k: g.clone() for k, g in zip(p, grads)}
            with torch.no_grad():
                for (k, w), g in zip(p.items(), grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(1e-8)
                    w.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
        return losses, first, {k: w.detach() for k, w in p.items()}


def _dropout(h: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    if rate <= 0.0:
        return h
    keep = 1.0 - rate
    u = torch.rand(h.shape, generator=gen, device=h.device)
    return torch.where(u < keep, h / keep, torch.zeros((), device=h.device))


def batches_of_rows(rows_per_step: List[np.ndarray], X, Y, ages, device):
    """[(x, y, age, mask)] on the device for each step's patient rows."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return [(t(X[r]), t(Y[r]), t(ages[r]), torch.ones(len(r), dtype=torch.bool, device=device))
            for r in rows_per_step]


def first_epoch_rows(cfg: dict, train_idx: np.ndarray, run_i: int = 0, fold_i: int = 0):
    """The first epoch's training batches as the protocol draws them: a
    permutation of the training rows from RandomState(seed + 1000 run +
    fold), in batches of batch_size, the ragged tail dropped."""
    rng = np.random.RandomState(cfg.get("seed", 1) + 1000 * run_i + fold_i)
    sel = np.asarray(train_idx)[rng.permutation(len(train_idx))]
    B = cfg["batch_size"]
    return [sel[s:s + B] for s in range(0, (len(sel) // B) * B, B)]
