"""Tracing and timing hooks (port of multilevel_gnn_tpu/utils/profiling.py).

- ``span(name)``, ``count(name, n)`` and ``recording()``: the port's own
  spans and counters, kept in memory while a ``recording()`` block is
  open, on the clock of torch.profiler's events (``time.time_ns``).  Off,
  the default, ``span`` returns one shared no-op context and ``count``
  returns at once.  The port's spans:

  ==================  ===================================================
  serve.request       train/predict.py predict_patients, whole call
  fold.epoch          train/driver.py run_fold, one epoch
  fold.plan           run_fold: the epoch's plan drawn, stacked, copied up
  fold.loss_readback  run_fold: the epoch's step losses read back
  fold.evaluate       train/driver.py evaluate, whole call
  eval.batch_in       iter_batches: one batch gathered, cast, copied up
  eval.readback       evaluate: one batch's mask, pred and loss read back
  step.train          train/step.py train_step, whole call
  step.eval           train/step.py eval_step, whole call
  kernel.K1           ops/kernels/segment_sum.py: the K1 op's call, from
                      its torch.library dispatch to the launch
  kernel.K2           ops/kernels/windowed.py: the same for K2
  kernel.PW.fwd       ops/kernels/pathway.py: the same for the pathway
  kernel.PW.bwd       contraction's forward and backward (PW)
  ==================  ===================================================

  The counter ``host_syncs`` counts the port's own blocking read-backs of
  device values: evaluate's three a batch and run_fold's one an epoch;
  ``pathway.dense_vmap`` counts the pathway contractions that took the
  dense route under torch.vmap (ops/pathway.py), one a vmapped call.
- ``trace(log_dir)``: a torch.profiler capture of the CPU and CUDA
  activities inside the block, written into log_dir as a Chrome trace
  (Perfetto or chrome://tracing open it), where the JAX package writes a
  jax.profiler trace, with the port's spans of the block added as complete
  events of category ``port_span`` above the profiler's own;
- ``AverageMeter`` and ``MetricStream`` as in the JAX package;
- ``enable_nan_debug``: torch's anomaly mode.

The JAX package's utils/runtime.py has no counterpart: its persistent
compilation cache is, for the port, the hashed ``_build/`` directories of
the kernels (ops/kernels/build.py) and the data libraries (data/native.py),
and what its configure_backend sets (kernel_backend, spmm_bf16) the port
reads from the config where it is used.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

TRACE_FILE = "trace.json"


class Span(NamedTuple):
    """One closed span: unix ns on the profiler's clock; parent is the
    index of the span that enclosed it on the same thread (-1 for a root:
    a span on autograd's device thread, where the backward's kernels
    launch, is a root there); thread is the native thread id."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    thread: int


@dataclasses.dataclass
class Recording:
    """What a ``recording()`` block leaves: its spans in the order they
    opened (a span still open at the block's end is closed there), its
    counters, and each hand-written kernel's launches in the block, read
    from ops/kernels/build.py's REGISTRY."""

    spans: List[Span] = dataclasses.field(default_factory=list)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


class _Recorder:
    """The open recording: a slot a span by the order it opened, filled
    with its (name, start_ns, end_ns, parent, thread) when it closes."""

    def __init__(self):
        self.slots: dict = {}
        self.ids = itertools.count()  # next() is atomic: two threads get two ids
        self.counts: Dict[str, int] = {}
        self.lock = threading.Lock()


_RECORDER: Optional[_Recorder] = None
_LOCAL = threading.local()
_NO_SPAN = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("rec", "name", "i", "parent", "thread", "start_ns")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        local = _LOCAL.__dict__
        stack = local.get("stack")
        if stack is None:
            stack = local["stack"] = []
            local["thread"] = threading.get_native_id()
        top = stack[-1] if stack else None
        self.parent = top.i if top is not None and top.rec is self.rec else -1
        self.thread = local["thread"]
        self.i = i = next(self.rec.ids)
        self.rec.slots[i] = self
        stack.append(self)
        self.start_ns = time.time_ns()

    def __exit__(self, *exc):
        end = time.time_ns()
        _LOCAL.stack.pop()
        self.rec.slots[self.i] = (self.name, self.start_ns, end, self.parent, self.thread)
        return False


def span(name: str):
    """A context that records the block as span ``name`` while a
    ``recording()`` block is open; otherwise one shared no-op context,
    with no clock read and nothing allocated."""
    rec = _RECORDER
    return _NO_SPAN if rec is None else _OpenSpan(rec, name)


def count(name: str, n: int = 1) -> None:
    """Adds n to counter ``name`` while a ``recording()`` block is open."""
    rec = _RECORDER
    if rec is not None:
        with rec.lock:
            rec.counts[name] = rec.counts.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Records the port's spans and counters in the block, from empty;
    yields a Recording, filled when the block ends.  A recording opened
    inside another takes the spans and counts of its own block, which the
    outer one does not see; the outer one goes on after it."""
    global _RECORDER
    from multilevel_gnn_tpu_torch.ops.kernels import build

    launches0 = {k: v.launches for k, v in build.REGISTRY.items()}
    outer, rec, out = _RECORDER, _Recorder(), Recording()
    _RECORDER = rec
    try:
        yield out
    finally:
        _RECORDER = outer
        end = time.time_ns()
        slots = dict(rec.slots)
        out.spans = [Span(*s) if isinstance(s, tuple) else
                     Span(s.name, s.start_ns, end, s.parent, s.thread)
                     for _, s in sorted(slots.items())]
        out.counts = dict(rec.counts)
        out.launches = {k: v.launches - launches0.get(k, 0)
                        for k, v in build.REGISTRY.items()}


def _add_spans(path: str, spans: List[Span]) -> None:
    """Appends spans to the Chrome trace at path as complete events on its
    own time base (its ts is (unix ns - baseTimeNanoseconds) / 1000)."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    doc["traceEvents"] += [
        {"ph": "X", "cat": "port_span", "name": s.name, "pid": pid, "tid": s.thread,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"index": i, "parent": s.parent}}
        for i, s in enumerate(spans)]
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA where a card is present) with the
    port's spans recorded, and write both to log_dir/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    with recording() as rec:
        with profile(activities=activities) as prof:
            yield prof
    prof.export_chrome_trace(path)
    _add_spans(path, rec.spans)


def enable_nan_debug() -> None:
    """torch's anomaly mode, the counterpart of jax_debug_nans (the
    reference's pdb-on-NaN breakpoints, multilevel_gnn.py:147-148).  They
    differ in what they check: torch checks every backward function's
    output for NaN and names the forward op that made it, while
    jax_debug_nans checks the output of every primitive, forward
    included."""
    torch.autograd.set_detect_anomaly(True)


class AverageMeter:
    """Running average (reference utils/metrics.py:8-24)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = 0.0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class MetricStream:
    """Append-only jsonl metric log (the reference logs dicts,
    train.py:169-176)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def log(self, **metrics):
        metrics.setdefault("ts", time.time())
        self._f.write(json.dumps(metrics) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
