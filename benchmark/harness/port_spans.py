"""The port's own spans and counters over a traced window (the Recording
of multilevel_gnn_tpu_torch/utils/profiling.py recording(), on the clock
of the profiler's events): each span name's count and summed host time,
the counters, the device's idle time split by the port's spans that
cover each idle nanosecond, and the ten per-layer numbers built on them
(split()).

The split keys each idle stretch by the names of every port span over it,
outermost first, joined by '/' ('serve.request/fold.evaluate/step.eval'),
so the last name is the innermost span.  Nesting is read from the times,
not from the spans' parents: a backward's kernel span, a root on
autograd's device thread, falls inside the step.train span of the thread
that waits for it.  Idle time under no span is keyed ''.

cell.run does not open the recorder, so no result line carries these
numbers: probes/span_probe.py (part 'split') takes a traced window as
cell.run does, with the recorder on, and prints them."""
from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Tuple

from harness import trace


def idle_by_path(spans: Iterable[Tuple[int, int, str]], gaps: List[Tuple[int, int]]
                 ) -> Dict[str, int]:
    """ns of the idle intervals ``gaps`` (sorted, disjoint) by the path of
    the spans (start_ns, end_ns, name) that cover them."""
    spans = [s for s in spans if s[1] > s[0]]
    # at one instant ends come before starts: a span covers [start, end)
    bounds = sorted([(a, 1, i) for i, (a, _, _) in enumerate(spans)]
                    + [(b, 0, i) for i, (_, b, _) in enumerate(spans)])
    active: Dict[int, Tuple[int, int, str]] = {}
    out: Dict[str, int] = collections.Counter()
    j, n, key = 0, len(bounds), ""

    def advance(t):
        nonlocal j, key
        moved = False
        while j < n and bounds[j][0] <= t:
            _, opens, i = bounds[j]
            if opens:
                active[i] = spans[i]
            else:
                active.pop(i, None)
            j += 1
            moved = True
        if moved:
            # outermost first: earlier start, then later end, then first opened
            key = "/".join(s[2] for _, s in sorted(
                active.items(), key=lambda kv: (kv[1][0], -kv[1][1], kv[0])))

    for a, b in gaps:
        t = a
        advance(t)
        while t < b:
            stop = min(b, bounds[j][0]) if j < n else b
            out[key] += stop - t
            t = stop
            advance(t)
    return dict(out)


def summarise(snap, red: Dict) -> Dict:
    """What the readers take from one traced window: spans by name (count,
    summed host ns), the counters, and the idle split over the window
    [red t0, t1]."""
    n, host = collections.Counter(), collections.Counter()
    for s in snap.spans:
        n[s.name] += 1
        host[s.name] += s.end_ns - s.start_ns
    gaps = trace.gaps(red["device"], red["t0"], red["t1"])
    idle = idle_by_path(((s.start_ns, s.end_ns, s.name) for s in snap.spans), gaps)
    return {"n": dict(n), "host_ns": dict(host), "counts": dict(snap.counts),
            "idle_ns": idle}


def _idle_under(p: Dict, name: str, outside: str = None) -> int:
    """Idle ns under span ``name`` (at any depth), less what lies under
    span ``outside`` as well."""
    total = 0
    for path, ns in p["idle_ns"].items():
        names = path.split("/")
        if name in names and (outside is None or outside not in names):
            total += ns
    return total


def _per(p: Dict, value: float, span: str):
    """value over the number of ``span`` spans, or None when there are none."""
    k = p["n"].get(span, 0)
    return value / k if k else None


def _mean_host_us(p: Dict, names: List[str]):
    """The mean host us of the spans ``names`` together."""
    k = sum(p["n"].get(s, 0) for s in names)
    return sum(p["host_ns"].get(s, 0) for s in names) / k / 1e3 if k else None


def split(p: Dict, kind: str, window_s: float) -> Dict[str, float]:
    """The per-layer numbers of summary ``p`` of one window of
    ``window_s`` seconds, for a serve window (per serve.request: host ms
    of the batch uploads and read-backs, host_syncs over the step.eval
    batches, device idle ms under step.eval and under serve.request
    outside it, and the mean host us of a K1 / K2 call) or a train
    window (host ms an epoch under fold.plan and fold.loss_readback, the
    device's idle under fold.evaluate as % of the window, idle ms a
    step under step.train, the K1 / K2 call); a number with nothing to
    count over is left out."""
    ms, kernels = 1e6, ["kernel.K1", "kernel.K2"]
    if kind == "serve":
        req = "serve.request"
        got = {
            "batch_in_ms.serve": _per(p, p["host_ns"].get("eval.batch_in", 0) / ms, req),
            "readback_ms.serve": _per(p, p["host_ns"].get("eval.readback", 0) / ms, req),
            "syncs_per_batch.serve": _per(p, p["counts"].get("host_syncs", 0), "step.eval"),
            "step_idle_ms.serve": _per(p, _idle_under(p, "step.eval") / ms, req),
            "off_step_idle_ms.serve": _per(p, _idle_under(p, req, "step.eval") / ms, req),
            "launch_host_us.serve": _mean_host_us(p, kernels),
        }
    else:
        host = p["host_ns"].get("fold.plan", 0) + p["host_ns"].get("fold.loss_readback", 0)
        got = {
            "epoch_host_ms.train": _per(p, host / ms, "fold.epoch"),
            "evaluate_idle_share.train": (100.0 * _idle_under(p, "fold.evaluate") / 1e9
                                          / window_s if window_s > 0 else None),
            "step_idle_ms.train": _per(p, _idle_under(p, "step.train") / ms, "step.train"),
            "launch_host_us.train": _mean_host_us(p, kernels),
        }
    return {k: v for k, v in got.items() if v is not None}
