"""Tracing and timing hooks (port of multilevel_gnn_tpu/utils/profiling.py).

- ``trace(log_dir)``: a torch.profiler capture of the CPU and CUDA
  activities inside the block, written into log_dir as a Chrome trace
  (Perfetto or chrome://tracing open it), where the JAX package writes a
  jax.profiler trace;
- ``StepTimer``: step times that end in a device synchronize (where JAX
  blocks on the step's result) and an edges/s counter;
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
import json
import os
import time

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA where a card is present) and write
    log_dir/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def enable_nan_debug() -> None:
    """torch's anomaly mode, the counterpart of jax_debug_nans (the
    reference's pdb-on-NaN breakpoints, multilevel_gnn.py:147-148).  They
    differ in what they check: torch checks every backward function's
    output for NaN and names the forward op that made it, while
    jax_debug_nans checks the output of every primitive, forward
    included."""
    torch.autograd.set_detect_anomaly(True)


def _sync(result) -> None:
    tensors = result if isinstance(result, (tuple, list)) else (result,)
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)


class StepTimer:
    """Step timer whose steps end when the device has finished their work,
    with an edges/s counter."""

    def __init__(self, edges_per_step: int = 0, batch_per_step: int = 1):
        self.edges_per_step = edges_per_step
        self.batch_per_step = batch_per_step
        self.times = []

    @contextlib.contextmanager
    def step(self, result_to_block=None):
        """Time the block; the device result put in out["result"] (or
        result_to_block) is waited for before the clock stops."""
        t0 = time.perf_counter()
        out = {}
        yield out
        if "result" in out:
            _sync(out["result"])
        elif result_to_block is not None:
            _sync(result_to_block)
        self.times.append(time.perf_counter() - t0)

    @property
    def mean_s(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def edges_per_s(self) -> float:
        if not self.times or not self.edges_per_step:
            return 0.0
        return self.edges_per_step * self.batch_per_step / self.mean_s


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
