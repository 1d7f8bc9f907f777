"""The halo scaling bench (port of multilevel_gnn_tpu/parallel/scaling.py:
run_bench_scaling :39-172, maybe_init_multihost :175-189).

    python -m multilevel_gnn_tpu_torch.train.cli --config configs/gbm.yaml \\
        --synthetic --bench-scaling [--mesh 1xK] [--device cpu]

The single-device anchor first: the mean gather_scatter on the windowed
GBM-scale cohort graph (N = 15,405 node slots, E ~ 154k edges with self
loops), forward and backward, B = 2 patients of C = 64 channels, through K2
and K1.  Then the halo form (parallel/halo.py) forward and backward at each
model size k of 2, 4, 8, ... that the host's cards hold (on the CPU, up to
the --mesh model size), in k spawned ranks over NCCL (gloo on the CPU),
each on its own card; in a process group that already exists (the
MGTPU_* variables) at k = its size, on its ranks.  One JSON line: ms per
call, edges/s/chip, the efficiency against the anchor, and the predicted
bytes on the wire per conv (the all_to_all's k (k-1) B H C f32 against the
full psum's 2 (k-1) B N_pad C) with the halo size H.  Device times come
from CUDA events on a card, from the host clock on the CPU.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

B, C = 2, 64  # the aggregation's feature block


def gbm_graph(device, windowed: bool = True):
    """The bench's graph: make_gbm_scale_setup(topology='cohort',
    topo_seed=0)'s, self-looped, windowed (perm_group 3), on device."""
    from multilevel_gnn_tpu_torch.core.graph import Graph
    from multilevel_gnn_tpu_torch.data.synthetic import make_cohort_topology

    rng = np.random.RandomState(0)
    send, recv, nodes = make_cohort_topology(rng, n_genes=5135)
    attr = rng.rand(len(send)).astype(np.float32)
    g = Graph.from_edges(np.stack([send, recv]), attr, nodes).with_self_loops()
    if windowed:
        g = g.with_window_meta(perm_group=3)
    return g.with_sorted_meta(device)


def _features(seed: int, n_nodes: int, device) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.randn(n_nodes, B, C).astype(np.float32)).to(device)


def _timed(fn, iters: int, device) -> float:
    """ms per call of fn after one warm call: CUDA events on a card, the
    host clock on the CPU."""
    fn()
    if device.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _fwd_bwd(agg, x):
    """One forward and backward of agg at x (a leaf needing grad)."""
    def call():
        x.grad = None
        (agg(x) * 0.001).sum().backward()
    return call


def halo_rank_ms(rank: int, k: int, seed: int, iters: int, device_kind: str) -> dict:
    """Rank ``rank`` of k: the halo aggregation's ms per forward and
    backward on its block, with H and its interior / boundary edge counts."""
    from multilevel_gnn_tpu_torch.parallel.halo import (
        build_halo_partition,
        halo_gather_scatter,
        pad_nodes_for,
    )

    dev = torch.device(f"cuda:{torch.cuda.current_device()}") if device_kind == "cuda" \
        else torch.device("cpu")
    graph = gbm_graph(dev, windowed=False)
    hp = build_halo_partition(graph, k, windowed=True)
    rh = hp.for_rank(rank, dist.group.WORLD, dev, graph)
    x = pad_nodes_for(_features(seed, graph.n_nodes, dev).reshape(graph.n_nodes, -1), hp)
    xb = x[rank * hp.n_local:(rank + 1) * hp.n_local].clone().requires_grad_(True)
    ms = _timed(_fwd_bwd(lambda v: halo_gather_scatter(v, rh, "mean", rh.edge_attr), xb),
                iters, dev)
    return {"ms": ms, "H": hp.halo, "n_local": hp.n_local, "k": k,
            "interior": rh.n_interior, "boundary": rh.n_boundary}


def _comm_device(dev):
    """Where the group's collectives take their tensors: the card under
    NCCL, the host under gloo."""
    return dev if dist.get_backend() == "nccl" else torch.device("cpu")


def run_bench_scaling(cfg, sizes=None, iters: int = 10, out=None,
                      device="cuda", extra: Optional[dict] = None) -> dict:
    """The bench (module docstring); prints its JSON line to out (stdout
    by default; rank 0 only, in a process group) and returns it.  extra:
    keys added after JAX's (the train CLI adds its builds' seconds)."""
    from multilevel_gnn_tpu_torch.core.device import resolve_device
    from multilevel_gnn_tpu_torch.ops import spmm
    from multilevel_gnn_tpu_torch.parallel.multihost import spawn

    dev = resolve_device(device)
    in_group = dist.is_initialized()
    if in_group:
        n_dev = dist.get_world_size()
    elif dev.type == "cuda":
        n_dev = torch.cuda.device_count()
    else:
        n_dev = max(cfg.mesh_model_axis, 1)
    if sizes is None:
        want = max(cfg.mesh_model_axis, 1)
        sizes = sorted({s for s in (1, 2, 4, 8, 16, 32) if s <= min(n_dev, max(want, 2))})
    seed = int(time.time()) % 1_000_000
    if in_group:  # every rank draws rank 0's features
        t = torch.tensor([seed], dtype=torch.int64, device=_comm_device(dev))
        dist.broadcast(t, src=0)
        seed = int(t.item())

    graph = gbm_graph(dev)
    E = int(graph.n_edges)
    x = _features(seed, graph.n_nodes, dev).requires_grad_(True)
    results = {"sizes": [], "ms": {}, "edges_per_s_per_chip": {}, "efficiency": {},
               "wire_bytes_per_conv": {}, "psum_equiv_bytes": {}, "halo_H": {}}
    dt1 = _timed(_fwd_bwd(lambda v: spmm.gather_scatter(v, graph, "mean", graph.edge_attr),
                          x), iters, dev)
    anchor = B * E / (dt1 / 1e3)
    results["sizes"].append(1)
    results["ms"]["1"] = dt1
    results["edges_per_s_per_chip"]["1"] = anchor
    results["efficiency"]["1"] = 1.0
    print(f"k=1 anchor: {dt1:.3f} ms fwd+bwd, {anchor:.3e} edges/s/chip", file=sys.stderr)

    for k in sizes:
        if k == 1 or k > n_dev:
            continue
        if in_group:
            if k != n_dev:
                continue
            ranks = [halo_rank_ms(dist.get_rank(), k, seed, iters, dev.type)]
            t = torch.tensor([ranks[0]["ms"]], dtype=torch.float64,
                             device=_comm_device(dev))
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            ranks[0]["ms"] = float(t.item())
        else:
            ranks = spawn(halo_rank_ms, k, k, seed, iters, dev.type,
                          backend="nccl" if dev.type == "cuda" else "gloo",
                          deadline_s=900)
        dtk = max(r["ms"] for r in ranks)
        H, Nl = ranks[0]["H"], ranks[0]["n_local"]
        eps_chip = B * E / (dtk / 1e3) / k
        wire = k * (k - 1) * B * H * C * 4
        psum_eq = 2 * (k - 1) * B * k * Nl * C * 4
        results["sizes"].append(k)
        results["ms"][str(k)] = dtk
        results["edges_per_s_per_chip"][str(k)] = eps_chip
        results["efficiency"][str(k)] = eps_chip / anchor
        results["wire_bytes_per_conv"][str(k)] = wire
        results["psum_equiv_bytes"][str(k)] = psum_eq
        results["halo_H"][str(k)] = H
        print(f"k={k}: {dtk:.3f} ms, {eps_chip:.3e} edges/s/chip, eff "
              f"{eps_chip / anchor:.2f}, H={H}, wire {wire / 1e6:.1f} MB/conv "
              f"(psum equiv {psum_eq / 1e6:.1f} MB)", file=sys.stderr)

    payload = {
        "metric": "halo_scaling_efficiency",
        "value": results["efficiency"].get(str(max(results["sizes"]))),
        "unit": "x",
        "backend": dev.type,
        "n_devices": n_dev,
        "E": E,
        "B": B,
        "C": C,
        **results,
        **(extra or {}),
    }
    if not in_group or dist.get_rank() == 0:
        print(json.dumps(payload), file=out or sys.stdout, flush=True)
    return payload


def maybe_init_multihost(backend: Optional[str] = None) -> Optional[int]:
    """Join the process group of MGTPU_COORDINATOR (host:port) /
    MGTPU_NUM_PROC / MGTPU_PROC_ID when MGTPU_COORDINATOR is set; returns
    this process's id, or None when it is unset."""
    coord = os.environ.get("MGTPU_COORDINATOR")
    if not coord:
        return None
    from multilevel_gnn_tpu_torch.parallel.multihost import initialize_multihost

    n = int(os.environ["MGTPU_NUM_PROC"])
    pid = int(os.environ["MGTPU_PROC_ID"])
    initialize_multihost(coord, n, pid, backend)
    return pid
