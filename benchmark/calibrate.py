#!/usr/bin/env python3
"""The readings that the limits of limits/<cell>.json are set from, in
one process on the chip at the cell's own size (the benchmark's runs do
not run this):

    python3 benchmark/calibrate.py --workload <cell> --seeds S1,S2,... \\
        [--control-seeds C1,C2,C3] [--requests 64]

For each seed, one JSON line of the numbers that decide `correct`:
  program     the port as the configuration states it (the lower reading)
  control     the reference in fp8 (e4m3's mantissa) where the
              configuration's trunk is bfloat16, put in the program's
              place (the upper reading)
  half_batch  each batch's second half left out, the mean taken over the
              rest (serve: the port's eval_step; train: the reference put
              in the program's place)
  altered     serve: one patient's answer turned to the other class where
              eval_step produces it
The fold's plans are built once; each seed draws its own cohort, weights
and requests.  A serve seed runs `--requests` requests of the cell's mix
through predict_patients and compares all of them; a train seed compares
the first steps of run_fold's first epoch."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import env  # noqa: E402

env.pin_process()


def half_mask(real):
    def call(model, batch, ctx, *a, **k):
        m = batch.sample_mask.clone()
        m[len(m) // 2:] = False
        return real(model, dataclasses.replace(batch, sample_mask=m), ctx, *a, **k)
    return call


def altered(real):
    def call(*a, **k):
        pred, loss = real(*a, **k)
        pred = pred.clone()
        pred[0] = pred[0].flip(-1)
        return pred, loss
    return call


def serve_readings(man, cell, seed, dev, shared, n_requests, control, faults):
    import torch

    from harness import cell as runner
    from harness import check
    from harness.traffic import patched
    from multilevel_gnn_tpu_torch.train import driver

    sut, load = runner.setup(man, cell, seed, dev, shared)
    load.warm()
    out = {}
    runs = [("program", None)]
    if faults:
        runs += [("half_batch", half_mask), ("altered", altered)]
    recs = {}
    for kind, fault in runs:
        with (patched(driver, "eval_step", fault) if fault else contextlib.nullcontext()):
            recs[kind] = load.window(float("inf"), False, max_requests=n_requests)
    cfg, fold, w, ref_mod = sut["conf"]["config"], sut["fold"], sut["weights"], sut["ref_mod"]
    sut["model"] = None
    gc.collect()
    torch.cuda.empty_cache()
    ref = ref_mod.Reference(cfg, fold, dev)
    with runner._no_tf32():
        for kind, rec in recs.items():
            out[kind] = check.serve_numbers(ref, w, rec["served"], load.requests, sut, seed,
                                            n_requests)
        if control:
            ref8 = ref_mod.Reference(cfg, fold, dev, precision="fp8")
            t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
            served = []
            for i in range(n_requests):
                rows = load.requests[i]
                p, l = ref8.evaluate(w, t(sut["X"][rows]), t(sut["Y"][rows]),
                                     t(sut["ages"][rows]))
                served.append((i, p[:, 0].double().cpu().tolist(), float(l)))
            out["control"] = check.serve_numbers(ref, w, served, load.requests, sut, seed,
                                                 n_requests)
    return out


def train_readings(man, cell, seed, dev, shared, control, faults):
    import torch

    from harness import cell as runner
    from harness import check

    sut, load = runner.setup(man, cell, seed, dev, shared)
    warm = load.warm(0.0, timing=False)
    cfg, fold, ref_mod = sut["conf"]["config"], sut["fold"], sut["ref_mod"]
    sut["model"] = None
    gc.collect()
    torch.cuda.empty_cache()
    cap = warm["capture"]
    batches, p0, cw = runner.train_inputs(ref_mod, cfg, load, sut, len(cap["losses"]), dev)
    steps = len(cap["losses"])
    out = {}
    with runner._no_tf32():
        ref = ref_mod.Reference(cfg, fold, dev)
        r = ref.train(p0, batches, cw, steps)
        out["program"] = check.train_numbers(cap["losses"], cap["grad"], cap["params"], p0, *r)
        if control:
            c = ref_mod.Reference(cfg, fold, dev, precision="fp8").train(p0, batches, cw, steps)
            out["control"] = check.train_numbers(*c, p0, *r)
        if faults:
            h = ref.train(p0, batches, cw, steps, fault="half_batch")
            out["half_batch"] = check.train_numbers(*h, p0, *r)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--requests", type=int, default=64)
    args = ap.parse_args(argv)
    import torch

    from harness.manifest import Manifest

    env.threads_after_import()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    man = Manifest()
    cell = man.cell(args.workload)
    kind = man.traffic(cell["traffic"])["kind"]
    dev = torch.device("cuda")
    shared = {}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in sorted(set(seeds) | controls, key=lambda s: (s not in controls, s)):
        t0 = time.perf_counter()
        c = seed in controls
        if kind == "serve":
            r = serve_readings(man, cell, seed, dev, shared, args.requests, c, c)
        else:
            r = train_readings(man, cell, seed, dev, shared, c, c)
        for k, v in r.items():
            print(json.dumps({"cell": args.workload, "seed": seed, "reading": k, **v,
                              "s": round(time.perf_counter() - t0, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
