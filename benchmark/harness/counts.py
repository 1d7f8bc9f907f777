"""The yardstick's arithmetic: the H100's published peaks, the byte bound
of each K1 / K2 launch worked out from the plans' shapes, and the
model's operations counted from its shapes.

Byte bound (as the port's kernel table counts it): each input byte read
once and each output byte written once, over the HBM rate.  K1 reads its
distinct source rows, writes its rows (read and written when it adds into
them), and reads rowptr, (col, w) per entry and w once per edge; K2 reads
its distinct source rows, writes all N rows in f32, and reads its tile,
block, entry and in-edge tables."""
from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense, at the full 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_BF16 = 989e12


def k1_bytes(plan, F: int, dsize: int, accumulate: bool) -> int:
    import torch

    rows_read = int(torch.unique(plan.col.long()).numel())
    rows_with_entries = int((plan.rowptr[1:] > plan.rowptr[:-1]).sum())
    out_rows = 2 * rows_with_entries if accumulate else plan.n_rows
    b = rows_read * F * dsize + out_rows * F * 4 + (plan.n_rows + 1) * 4
    return b + plan.nnz * 8 + int(torch.unique(plan.eid).numel()) * 4


def k2_bytes(plan, side, F: int, dsize: int) -> int:
    import torch

    rows_read = int(torch.unique(side.ent_src_orig).numel())
    b = rows_read * F * dsize + plan.num_nodes * F * 4
    b += 4 * (side.n_tiles + 1 + 2 * side.n_blocks + 1 + 2 * side.n_entries + 1
              + 2 * side.n_in)
    if plan.row_of is not None:
        b += 4 * plan.num_nodes
    return b


def sage_launches(cfg, graph, pca_gather, train: bool) -> List[Tuple[str, object, int, bool, str]]:
    """The K1 / K2 launches of one eval batch (train=False) or one train
    step of the windowed SAGE trunk: (kernel, plan, F, accumulate, side).
    Forward, per layer: K2 over the window, K1 adding the residual; the
    backward, per layer: K2 on the transpose side, K1 adding the transpose
    residual and the residual's transpose; and K1 as the PCA-row gather's
    backward."""
    B = cfg.batch_size
    widths = [cfg.node_embedding_dim] + [cfg.hidden_channels] * (cfg.num_layers - 1)
    wp = graph.winplan
    out = []
    for c in widths:
        F = B * c
        out.append(("K2", wp, F, False, "fwd"))
        out += [("K1", p, F, True, "") for p in (wp.res,) if p.nnz]
        if train:
            out.append(("K2", wp, F, False, "bwd"))
            out += [("K1", p, F, True, "") for p in (wp.tres, wp.res_csc) if p.nnz]
    if train:
        out.append(("K1", pca_gather, B * cfg.final_channels, False, ""))
    return out


def launch_bytes(launches, dsize: int) -> Dict[str, float]:
    """{'K1': bytes, 'K2': bytes, 'count_K1': n, 'count_K2': n}."""
    out = {"K1": 0.0, "K2": 0.0, "count_K1": 0, "count_K2": 0}
    for kind, plan, F, acc, side in launches:
        if kind == "K1":
            out["K1"] += k1_bytes(plan, F, dsize, acc)
        else:
            out["K2"] += k2_bytes(plan, plan.bwd if side == "bwd" else plan.fwd, F, dsize)
        out[f"count_{kind}"] += 1
    return out


def model_flops(conf: dict, nnz: int, n_nodes: int, pca_rows: int) -> Dict[str, float]:
    """Operations of one batch's forward ('eval') and of one training step
    ('train', three times the forward: the backward's two products per
    forward product), counted from the shapes: the SpMMs (2 nnz F), the
    SAGE GEMMs, the pathway contraction as the sum it is (2 G K B C), the
    head's convolutions and Linears."""
    cfg = conf["config"]
    B = cfg["batch_size"]
    f = 0.0
    emb, hid, fin = cfg["node_embedding_dim"], cfg["hidden_channels"], cfg["final_channels"]
    f += n_nodes * B * emb
    dims = [(emb, hid)] + [(hid, hid)] * max(cfg["num_layers"] - 2, 0) + [(hid, fin)]
    for cin, cout in dims:
        f += 2.0 * nnz * B * cin                        # SpMM
        f += 2.0 * n_nodes * B * cin * cout              # lin_r
        f += 2.0 * n_nodes * B * (cin + cout) * cout     # MLP
    K, P = cfg["pca_dim"], cfg["pathway_num"]
    f += 2.0 * pca_rows * K * B * fin
    ch, h, w = fin, P, 3 * K
    for out, k in zip(cfg["conv_channel_list"], cfg["conv_kernel_list"]):
        ch_out = out
        h, w = h + 2 * (k // 2) - k + 1, w + 2 * (k // 2) - k + 1
        f += 2.0 * B * h * w * ch * ch_out * k * k
        ch = ch_out
    flat = ch * (h // cfg["pathway_pool_dim"]) * (w // cfg["pca_pool_dim"])
    flat += 1 if cfg.get("use_age") else 0
    f += 2.0 * B * flat * cfg["head_dim"] + 2.0 * B * cfg["head_dim"] * 2
    return {"eval": f, "train": 3.0 * f}
