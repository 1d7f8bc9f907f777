"""One run of one cell: set-up (inputs from the seed, the port's fold and
model, warm-up of the cell's own shapes), the measured window, then the
check against the plain reference and the metrics' readers."""
from __future__ import annotations

import dataclasses
import gc
import math
import subprocess
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from harness import check, inputs, system, trace
from harness.manifest import Manifest
from harness.traffic import FoldTrain, Serve

SPANS = ("eval_step", "train_step", "evaluate", "request")


def card() -> Dict:
    """nvidia-smi's name and power limit of the card, read beside the run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        name, limit, clock = [s.strip() for s in out.splitlines()[0].split(",")]
        return {"name": name, "power_limit_w": float(limit), "max_sm_mhz": float(clock)}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {}


def host_probe() -> float:
    """ms of a fixed pure-Python loop: the host's pace beside the run (a
    shared host's cores run some runs slower than others)."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(300_000):
        acc += i & 7
    return (time.perf_counter() - t0) * 1e3


def setup(man: Manifest, cell: dict, seed: int, device, shared: Optional[Dict] = None
          ) -> Tuple[Dict, object]:
    """The system under test for one seed, and the cell's load.  shared:
    a dict that keeps the fold's tables and the port's fold context
    between seeds of one process (calibration); None builds them anew."""
    t = [time.perf_counter()]
    conf = man.config(cell["config"])
    mix = man.traffic(cell["traffic"])
    ref_mod = man.reference(conf["reference"])
    shared = {} if shared is None else shared
    if "fold" not in shared:
        shared["fold"] = inputs.make_fold(conf["fold"])
    fold = shared["fold"]
    cohort = inputs.make_cohort(conf["cohort"], fold["n_nodes"], seed, device)
    G = len(fold["gene_pca_match"])
    shapes = ref_mod.param_shapes(conf["config"], fold["n_nodes"], G)
    weights = inputs.make_weights(shapes, seed, device, G, conf["config"]["pca_dim"])
    t.append(time.perf_counter())
    cfg = system.config(conf)
    if "ctx" not in shared:
        shared["ctx"] = system.fold_context(conf, fold, weights["pca_seed"], device)
    ctx = dataclasses.replace(shared["ctx"], pca_seed=weights["pca_seed"].contiguous())
    t.append(time.perf_counter())
    model = system.model(cfg, ctx, weights, device)
    t.append(time.perf_counter())
    stages = dict(zip(("inputs_s", "fold_plans_s", "model_s"), np.diff(t).tolist()))
    sut = {"conf": conf, "cfg": cfg, "ctx": ctx, "model": model, "fold": fold,
           "weights": weights, "ref_mod": ref_mod, "stages": stages, **cohort}
    kind = {"serve": Serve, "fold_train": FoldTrain}[mix["kind"]]
    return sut, kind(mix, sut, seed)


def device_record(sut: Dict, red: Optional[Dict], rec: Dict) -> None:
    """The counts the per-layer readers take from the trace and the plans."""
    from harness import counts

    cfg, ctx = sut["cfg"], sut["ctx"]
    dsize = 2 if cfg.spmm_bf16 else 4
    for kind in ("eval", "train"):
        if kind == "train" and rec["kind"] != "train":
            continue
        if ctx.graph.winplan is not None and cfg.gnn_name == "sage":
            rec[f"bytes_{kind}"] = counts.launch_bytes(counts.sage_launches(
                cfg, ctx.graph, ctx.pca_gather, kind == "train"), dsize)
    flops = counts.model_flops(sut["conf"], ctx.graph.csr.nnz, ctx.graph.n_nodes,
                               ctx.num_pca_rows)
    rec["flops_eval"], rec["flops_train"] = flops["eval"], flops["train"]
    if red is not None:
        rec["busy_s"] = trace.busy_ns(red["device"]) / 1e9
        rec["kernels_in"] = {s: dict(trace.kernel_time_in(red, s)) for s in SPANS}


def run(cell_name: str, seed: int, seconds: float, traced: bool, device="cuda",
        man: Optional[Manifest] = None, t_start: Optional[float] = None) -> Dict:
    """The result line's dict; its last key, "checks", holds the compared
    numbers with their limits."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = man or Manifest()
    cell = man.cell(cell_name)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sut, load = setup(man, cell, seed, dev)
    t_warm = time.perf_counter()
    warm = load.warm(seconds) if isinstance(load, FoldTrain) else load.warm()
    if cuda:
        torch.cuda.synchronize()
    stages = {"start_s": t_warm - t_start - sum(sut["stages"].values()), **sut["stages"],
              "warm_s": time.perf_counter() - t_warm}
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    host_probe_ms = host_probe()

    red = None
    launches0 = system.kernel_launches()
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            t0_ns = time.time_ns()
            rec = load.window(seconds, True)
            t1_ns = time.time_ns()
        red = trace.reduce_events(prof.profiler.kineto_results.events(), SPANS,
                                  t0_ns, t1_ns)
        rec["window_s"] = (t1_ns - t0_ns) / 1e9
    else:
        rec = load.window(seconds, False)
    launches = system.kernel_launches()
    rec["launches"] = {k: launches[k] - launches0.get(k, 0) for k in launches}
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    rec["setup_s"] = setup_s
    rec["card"] = card() if cuda else {}
    device_record(sut, red, rec)

    # the program's state freed before the reference runs
    cfg_dict = sut["conf"]["config"]
    ref_mod, fold, weights = sut["ref_mod"], sut["fold"], sut["weights"]
    sut["model"] = sut["ctx"] = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = numbers_for(rec, warm, load, ref_mod, cfg_dict, fold, weights, sut, seed, dev)
    limits = man.limits(cell_name)
    correct = check.judge(numbers, limits)

    readers = man.readers(cell_name, traced)
    metrics = {}
    units = {m["name"]: m["unit"] for m in man.metrics(cell_name, traced)}
    for name, mod in readers.items():
        v = mod.read(rec)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": units[name]}
    attempted = rec.get("n_requests", rec.get("steps", 0))
    out = {
        "correct": bool(correct),
        "attempted": int(attempted),
        "failed": int(numbers.get("missing", 0)),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
        "card": rec["card"],
        "run": {"seed": seed, "seconds": seconds, "window_s": rec["window_s"],
                "setup_s": setup_s, "host_probe_ms": host_probe_ms,
                "setup_stages_s": stages, **({"epochs": rec["epochs"],
                                        "epoch_s_setup": warm["epoch_s"],
                                        "epoch_s_quartiles": rec["epoch_s_quartiles"]}
                                       if rec["kind"] == "train" else {})},
    }
    if red is not None:
        out["device"]["busy_s"] = rec["busy_s"]
        out["device"]["window_s"] = rec["window_s"]
        out["breakdown"] = {"device_ops": trace.device_ops(red["device"]),
                            "idle_gaps": trace.idle_gaps(red, list(SPANS))}
    out["checks"] = {k: {"value": numbers.get(k, math.inf), "limit": lim}
                     for k, lim in limits.items()}
    return out


def train_inputs(ref_mod, cfg: dict, load, sut: Dict, steps: int, dev):
    """What the reference's training steps start from: the first epoch's
    batches as the protocol draws them, the weights (the learnable PCA
    from the PCA seed under init_with_pca, as run_fold seeds it) and the
    class weights."""
    weights = sut["weights"]
    rows = ref_mod.first_epoch_rows(cfg, load.split[0])[:steps]
    batches = ref_mod.batches_of_rows(rows, sut["X"], sut["Y"], sut["ages"], dev)
    p0 = {k: v for k, v in weights.items() if k != "pca_seed"}
    if cfg.get("init_with_pca"):
        p0["learnable_pca_params"] = weights["pca_seed"]
    return batches, p0, torch.as_tensor(load.cw, device=dev)


def numbers_for(rec, warm, load, ref_mod, cfg, fold, weights, sut, seed, dev) -> Dict:
    ref = ref_mod.Reference(cfg, fold, dev)
    with _no_tf32():
        if rec["kind"] == "serve":
            return check.serve_numbers(ref, weights, rec["served"], load.requests, sut, seed,
                                       load.mix["check_requests"])
        cap = warm["capture"]
        steps = len(cap["losses"])
        batches, p0, cw = train_inputs(ref_mod, cfg, load, sut, steps, dev)
        r_losses, r_grads, r_params = ref.train(p0, batches, cw, steps)
        return check.train_numbers(cap["losses"], cap.get("grad"), cap.get("params"), p0,
                                   r_losses, r_grads, r_params)


class _no_tf32:
    """float32 without TF32 for the reference, the flags restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
