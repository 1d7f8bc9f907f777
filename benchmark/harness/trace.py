"""The traced window (--trace 1): torch.profiler over the whole window,
the benchmark's own spans (record_function around the calls into each
layer), and the reduction of the raw kineto events to what the per-layer
metrics and the result's device and breakdown keys read.

The events are read once from the profiler's raw results
(prof.profiler.kineto_results), not through key_averages(), whose Python
objects cost minutes over a window of some million events."""
from __future__ import annotations

import bisect
import collections
import re
from typing import Dict, List, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
SHORT_GAP_NS = 20_000
# the port's hand-written kernels, by their device-side symbols (K2's
# launch is its entry pre-pass and its tile kernel)
PORT_SYMBOLS = {
    "K1": ("segment_spmm_csr_kernel",),
    "K2": ("win_kernel", "entry_values"),
    "K3": ("segment_max_csr_kernel",),
    "K4": ("sorted_segment_sum_kernel",),
}


def clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_:.-]", "_", name)[:64]


def port_kernel(name: str):
    for k, syms in PORT_SYMBOLS.items():
        if any(s in name for s in syms):
            return k
    return None


class Spans:
    """Disjoint intervals of one span name, sorted, for containment tests."""

    def __init__(self, intervals: List[Tuple[int, int]]):
        iv = sorted(intervals)
        self.start = [a for a, _ in iv]
        self.end = [b for _, b in iv]

    def __len__(self):
        return len(self.start)

    def contains(self, t: int) -> bool:
        i = bisect.bisect_right(self.start, t) - 1
        return i >= 0 and t <= self.end[i]

    def total_ns(self) -> int:
        return sum(b - a for a, b in zip(self.start, self.end))


def activity(e) -> str:
    """The event's kind from its device and name (torch's kineto events
    do not all carry their activity type): on the device 'gpu_memcpy',
    'gpu_memset' or 'kernel' (a device-side mirror of a host annotation
    reads as a kernel until the launch filter below drops it); on the
    host 'cuda_runtime' for a CUDA runtime or driver call ('cuda*',
    'cu*'), else 'cpu_op'."""
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def reduce_events(events, span_names, t0_ns: int, t1_ns: int) -> Dict:
    """The window [t0_ns, t1_ns] (unix ns, the profiler's clock) of the raw
    kineto events: device operations with the time their launch was
    issued, the benchmark's spans by name, and the host's outermost
    operations per thread."""
    dev, launch_at, spans = [], {}, collections.defaultdict(list)
    ops = collections.defaultdict(list)
    for e in events:
        name = e.name()
        if name in span_names:
            # the benchmark's own spans: the host's range; their mirror on
            # the device's timeline (a GPU user annotation) is no operation
            if not str(e.device_type()).endswith("CUDA"):
                spans[name].append((e.start_ns(), e.start_ns() + e.duration_ns()))
            continue
        kind = activity(e)
        if kind in DEVICE_ACTIVITIES:
            dev.append((e.start_ns(), e.duration_ns(), name, e.correlation_id(), kind))
        elif kind == "cuda_runtime":
            launch_at[e.correlation_id()] = e.start_ns()
        elif kind == "cpu_op":
            ops[e.start_thread_id()].append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                             name))
    # an operation is one some launch or copy call issued (this leaves out
    # the device-side mirrors of the host's annotations, such as the
    # optimizer's own record_function ranges)
    dev = [d for d in dev if d[3] in launch_at and t0_ns <= d[0] and d[0] + d[1] <= t1_ns]
    outer = []
    for lst in ops.values():
        lst.sort()
        end = -1
        for a, b, n in lst:
            if a >= end:  # not inside the previous outermost op of this thread
                outer.append((a, b, n))
                end = b
    outer.sort()
    return {"device": dev, "launch_at": launch_at,
            "spans": {k: Spans(v) for k, v in spans.items()},
            "outer_ops": outer, "t0": t0_ns, "t1": t1_ns}


def busy_ns(dev) -> int:
    """Length of the union of the device operations' intervals."""
    total, cur_a, cur_b = 0, None, None
    for a, d, *_ in sorted(dev):
        b = a + d
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps(dev, t0: int, t1: int) -> List[Tuple[int, int]]:
    """The device's idle intervals within [t0, t1]."""
    out, cur = [], t0
    for a, d, *_ in sorted(dev):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, a + d)
    if t1 > cur:
        out.append((cur, t1))
    return out


def device_ops(dev, top: int = 10):
    by = collections.Counter()
    for _, d, name, _, _ in dev:
        by[clean(name)] += d
    return [[n, ns / 1e9] for n, ns in by.most_common(top)]


def idle_gaps(red: Dict, span_order: List[str], top: int = 10):
    """The idle time by what the host was doing when the device went
    idle: '<innermost benchmark span> / <outermost host op or idle>';
    gaps under 20 us pooled as launch gaps."""
    outer = red["outer_ops"]
    starts = [a for a, _, _ in outer]
    by = collections.Counter()
    for a, b in gaps(red["device"], red["t0"], red["t1"]):
        if b - a < SHORT_GAP_NS:
            by["launch gaps under 20 us"] += b - a
            continue
        span = next((s for s in span_order if s in red["spans"]
                     and red["spans"][s].contains(a)), "window")
        i = bisect.bisect_right(starts, a) - 1
        op = "idle"
        # the outermost ops of all threads are sorted by start; look back a
        # little for one that covers the gap's start
        for j in range(i, max(i - 8, -1), -1):
            if outer[j][1] >= a:
                op = outer[j][2]
                break
        by[f"{span} / {op}"] += b - a
    return [[clean(n), ns / 1e9] for n, ns in by.most_common(top)]


def kernel_time_in(red: Dict, span: str) -> Dict[str, float]:
    """Device seconds of the kernels whose launch was issued inside
    ``span``, by class: the port's K1..K4, 'dense' (every other kernel),
    'copy' (memcpy and memset)."""
    sp = red["spans"].get(span)
    out = collections.Counter()
    if sp is None:
        return out
    for start, d, name, corr, kind in red["device"]:
        t = red["launch_at"].get(corr)
        if t is None or not sp.contains(t):
            continue
        if kind != "kernel":
            out["copy"] += d / 1e9
        else:
            out[port_kernel(name) or "dense"] += d / 1e9
    return out
