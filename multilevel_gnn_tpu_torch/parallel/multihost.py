"""Process-group setup (port of multilevel_gnn_tpu/parallel/multihost.py).

One process per rank, one card per process: ``initialize_multihost``
joins the torch.distributed group of ``num_processes`` ranks at
``coordinator_address`` (host:port; the TCP store's server is rank 0's),
over NCCL on cards and gloo on the CPU, where JAX's ``cpu_collectives``
chooses the CPU collectives.  Failure model as JAX's: a barrier at init
(the group forms or the timeout ends it) and checkpoint-restart, no
elastic membership.
"""
from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

# every group gets a deadline: a rank that fails before a collective must
# not leave the others waiting for ever
TIMEOUT_S = 120


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    timeout_s: float = TIMEOUT_S,
) -> dict:
    """Join (or, with one process and no coordinator, skip) the process
    group; returns JAX's four keys: process_index, process_count,
    local_devices and global_devices (one device a process).

    backend: 'nccl' or 'gloo' (default: nccl where a card is present, else
    gloo).  init_method overrides the coordinator (a file:// store, as the
    tests use).  A process whose rank has a card of its own selects
    cuda:rank mod the host's cards."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    n = int(num_processes or 1)
    if not dist.is_initialized() and (n > 1 or coordinator_address or init_method):
        if init_method is None:
            init_method = f"tcp://{coordinator_address}"
        if backend == "nccl":
            torch.cuda.set_device(int(process_id or 0) % torch.cuda.device_count())
        dist.init_process_group(
            backend=backend, init_method=init_method, world_size=n,
            rank=int(process_id or 0),
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    world = dist.get_world_size() if dist.is_initialized() else 1
    index = dist.get_rank() if dist.is_initialized() else 0
    return {
        "process_index": index,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }


def global_mesh(n_model: int = 1):
    """('data', 'model') mesh over every rank of the group, 'model' on the
    fastest-varying axis (neighbouring ranks, the same host's cards),
    'data' across: only the gradient all-reduce crosses hosts."""
    from multilevel_gnn_tpu_torch.parallel.mesh import make_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % n_model:
        raise ValueError(f"{n} ranks do not split into model groups of {n_model}")
    return make_mesh(n // n_model, n_model)


def free_port() -> int:
    """A TCP port on localhost that no socket holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, n, backend, init_method, timeout_s, out, args):
    """A spawned rank: one thread of torch ops, the group, fn(rank, *args);
    its result or its traceback goes to out (the parent raises it again,
    naming the rank)."""
    torch.set_num_threads(1)
    try:
        initialize_multihost(None, n, rank, backend, init_method, timeout_s)
        out.put((rank, True, fn(rank, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n: int, *args, backend: str = "gloo",
          init_method: Optional[str] = None, deadline_s: float = 600,
          timeout_s: float = TIMEOUT_S) -> List:
    """Run fn(rank, *args) in n spawned processes that form one group
    (init_method, or a TCP store on a free localhost port); returns the
    ranks' results in rank order.  fn must be importable (a module-level
    function).  A rank that raises, exits or outlives deadline_s ends
    every rank, and the call raises RuntimeError with the rank's
    traceback."""
    import torch.multiprocessing as mp

    if init_method is None:
        init_method = f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n, backend, init_method, timeout_s, out, args))
             for r in range(n)]
    env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for p in procs:
            p.start()
    finally:
        if env is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = env
    results, end = {}, time.monotonic() + deadline_s
    try:
        while len(results) < n:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > end:
                    raise RuntimeError(f"ranks {sorted(set(range(n)) - set(results))} "
                                       f"did not finish within {deadline_s} s")
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and out.empty():
                    raise RuntimeError(f"a rank exited with code {dead[0]}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(max(end - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [results[r] for r in range(n)]
