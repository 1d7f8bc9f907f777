#!/usr/bin/env python3
"""The port's span recorder (multilevel_gnn_tpu_torch/utils/profiling.py)
on the card, at the benchmark's cells' size and with their set-up:

    PYTHONPATH=. python3 probes/span_probe.py [--parts micro,clock,split,cost,syncs]
        [--seconds S] [--seed N] [--out FILE]

Prints one JSON line a part (and appends them to --out, runs/span_probe.jsonl):
- micro: ns a call of time.time_ns, perf_counter, get_native_id and of an
  empty span, recording off and on.
- clock: one traced kirc-serve window as the benchmark traces it: each
  step.eval span's start less the start of the benchmark's eval_step
  record_function event around it, and that event's end less the span's
  end (ns; median, max, count), from the profiler's kineto events; the
  same for serve.request in the benchmark's request event.
- split: one traced window of kirc-serve, gbm-serve and kirc-train as
  the benchmark traces it, with the recorder on: the ten per-layer numbers
  of benchmark/harness/port_spans.py (the device's idle split by the
  port's spans over it, the uploads, read-backs, syncs a batch and a K1 /
  K2 call's host us), beside host_ms.serve and the idle share.
- cost: windows of kirc-serve and gbm-serve (ms a request) and kirc-train
  (ms a training step), recording off, on, on, off twice, each S seconds, with
  the mean host us of the kernel spans in the windows recorded.
- cost_traced: kirc-serve and gbm-serve windows under the profiler as the
  benchmark's traced run takes them, recording off and on in turns.
- syncs: torch.cuda.set_sync_debug_mode("warn") over one request of
  kirc-serve and one run_fold epoch of kirc-train: every synchronising
  call, by the Python line that made it, beside the port's host_syncs."""
import time

import argparse
import bisect
import collections
import contextlib
import json
import statistics
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

from harness import env  # noqa: E402

env.pin_process()


def emit(out, **line):
    print(json.dumps(line), flush=True)
    out.write(json.dumps(line) + "\n")
    out.flush()


def setup(man, name, seed, dev):
    from harness import cell

    return cell.setup(man, man.cell(name), seed, dev)


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def traced_window(load, seconds, dev):
    """One window as cell.run traces it (the profiler, the benchmark's
    spans), with the port's recorder on over it: the window's record, the
    reduced events and the Recording."""
    from torch.profiler import ProfilerActivity, profile

    from harness import cell, trace
    from multilevel_gnn_tpu_torch.utils.profiling import recording

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.time_ns()
        with recording() as snap:
            rec = load.window(seconds, True)
        t1 = time.time_ns()
    red = trace.reduce_events(prof.profiler.kineto_results.events(), cell.SPANS, t0, t1)
    rec["window_s"] = (t1 - t0) / 1e9
    return rec, red, snap


def clock(man, seed, seconds, dev, out):
    _, load = setup(man, "kirc-serve", seed, dev)
    load.warm()
    sync(dev)
    _, red, snap = traced_window(load, seconds, dev)
    for event, name in (("eval_step", "step.eval"), ("request", "serve.request")):
        outer = red["spans"][event]
        starts, ends, missed = [], [], 0
        for s in snap.spans:
            if s.name != name:
                continue
            i = bisect.bisect_right(outer.start, s.start_ns) - 1
            if i < 0 or s.end_ns > outer.end[i]:
                missed += 1
                continue
            starts.append(s.start_ns - outer.start[i])
            ends.append(outer.end[i] - s.end_ns)
        emit(out, part="clock", cell="kirc-serve", event=event, span=name,
             pairs=len(starts), outside=missed, events=len(outer),
             start_ns={"median": statistics.median(starts), "max": max(starts),
                       "min": min(starts)},
             end_ns={"median": statistics.median(ends), "max": max(ends),
                     "min": min(ends)})


def split(man, seed, seconds, dev, out, cells=("kirc-serve", "gbm-serve", "kirc-train")):
    """A traced window of each cell with the recorder on: the ten numbers
    of harness/port_spans.py split(), beside the benchmark's host_ms.serve
    and idle share of the same window."""
    from harness import port_spans, trace

    for name in cells:
        _, load = setup(man, name, seed, dev)
        train = name.endswith("train")
        load.warm(seconds) if train else load.warm()
        sync(dev)
        rec, red, snap = traced_window(load, seconds, dev)
        busy_s = trace.busy_ns(red["device"]) / 1e9
        got = port_spans.split(port_spans.summarise(snap, red), rec["kind"], rec["window_s"])
        line = {"part": "split", "cell": name, "window_s": rec["window_s"],
                "idle_share": 1 - busy_s / rec["window_s"], **got}
        if not train:
            line["host_ms.serve"] = 1e3 * (sum(rec["request_s"]) - busy_s) / rec["n_requests"]
            line["step_plus_off_step_over_host"] = (
                (got["step_idle_ms.serve"] + got["off_step_idle_ms.serve"])
                / line["host_ms.serve"])
        emit(out, **line)


@contextlib.contextmanager
def windowed(mode, traced, dev):
    """The block under the profiler as the benchmark's traced window runs
    it (traced), with the recorder on (mode 'on') or off."""
    from torch.profiler import ProfilerActivity, profile

    from multilevel_gnn_tpu_torch.utils.profiling import recording

    with contextlib.ExitStack() as stack:
        if traced:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                              if dev.type == "cuda" else [])
            stack.enter_context(profile(activities=acts))
        yield stack.enter_context(recording()) if mode == "on" else None


def cost(man, seed, seconds, dev, out, modes=("off", "on", "on", "off") * 2,
         traced=False, cells=("kirc-serve", "gbm-serve", "kirc-train")):
    for name in cells:
        _, load = setup(man, name, seed, dev)
        train = name.endswith("train")
        load.warm(seconds) if train else load.warm()
        sync(dev)
        rows = []
        for mode in modes:
            with windowed(mode, traced, dev) as snap:
                rec = load.window(seconds, traced)
            n = rec["steps"] if train else rec["n_requests"]
            row = {"mode": mode, "ms": 1e3 * rec["window_s"] / n, "n": n}
            if snap is not None:
                k = [s.end_ns - s.start_ns for s in snap.spans if s.name.startswith("kernel.")]
                row.update(spans=len(snap.spans), kernel_spans=len(k),
                           kernel_us=sum(k) / len(k) / 1e3 if k else None)
            rows.append(row)
        med = {m: statistics.median(r["ms"] for r in rows if r["mode"] == m)
               for m in set(modes)}
        emit(out, part="cost_traced" if traced else "cost", cell=name,
             unit="ms a step" if train else "ms a request", runs=rows,
             over_off={m: v / med["off"] - 1 for m, v in med.items() if m != "off"})


def micro(out, n=200_000):
    """ns a call of the clock and of a span, off and on, in this process."""
    import threading

    from multilevel_gnn_tpu_torch.utils.profiling import recording, span

    def per(f):
        t = time.perf_counter()
        for _ in range(n):
            f()
        return (time.perf_counter() - t) / n * 1e9

    def one():
        with span("x"):
            pass

    got = {"time_ns": per(time.time_ns), "perf_counter": per(time.perf_counter),
           "get_native_id": per(threading.get_native_id), "span_off": per(one)}
    with recording():
        got["span_on"] = per(one)
    emit(out, part="micro", ns=got)


def syncs(man, seed, dev, out):
    import torch

    from multilevel_gnn_tpu_torch.utils.profiling import recording

    def by_line(fn):
        with warnings.catch_warnings(record=True) as got, recording() as snap:
            warnings.simplefilter("always")
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
                sync(dev)
            finally:
                if dev.type == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
        lines = collections.Counter(
            f"{where(w.filename)}:{w.lineno}" for w in got if "synchroniz" in str(w.message))
        return snap, lines

    def where(f):
        f = Path(f)
        return f.relative_to(ROOT) if f.is_relative_to(ROOT) else f

    _, load = setup(man, "kirc-serve", seed, dev)
    load.warm()
    snap, lines = by_line(lambda: load._call(load.requests[0]))
    emit(out, part="syncs", cell="kirc-serve", what="one predict_patients call",
         step_eval=sum(s.name == "step.eval" for s in snap.spans),
         host_syncs=snap.counts.get("host_syncs", 0), warned=dict(lines))
    _, load = setup(man, "kirc-train", seed, dev)
    load.warm(1.0, timing=False)
    snap, lines = by_line(lambda: load._run(1))
    emit(out, part="syncs", cell="kirc-train", what="one run_fold epoch",
         step_train=sum(s.name == "step.train" for s in snap.spans),
         step_eval=sum(s.name == "step.eval" for s in snap.spans),
         host_syncs=snap.counts.get("host_syncs", 0), warned=dict(lines))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="micro,clock,split,cost,syncs")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=7_000_000_001)
    ap.add_argument("--out", default=str(ROOT / "runs" / "span_probe.jsonl"))
    args = ap.parse_args(argv)
    import torch

    env.threads_after_import()
    from harness.manifest import Manifest

    if not torch.cuda.is_available():
        raise SystemExit("span_probe.py measures the card: no CUDA device")
    man = Manifest()
    dev = torch.device("cuda")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as out:
        from harness.cell import card

        emit(out, part="card", **card())
        for part in args.parts.split(","):
            if part == "clock":
                clock(man, args.seed, args.seconds, dev, out)
            elif part == "cost":
                cost(man, args.seed + 1, args.seconds, dev, out)
            elif part == "cost_traced":
                cost(man, args.seed + 3, args.seconds, dev, out,
                     modes=("off", "on", "on", "off") * 3,
                     traced=True, cells=("kirc-serve", "gbm-serve"))
            elif part == "split":
                split(man, args.seed + 4, args.seconds, dev, out)
            elif part == "micro":
                micro(out)
            elif part == "syncs":
                syncs(man, args.seed + 2, dev, out)
            else:
                raise SystemExit(f"unknown part {part!r}")


if __name__ == "__main__":
    main()
