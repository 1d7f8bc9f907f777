"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Each kernel is a plain C entry point of one ``csrc/*.cu`` file (a file may
hold several kernels' entry points).  At first use the file is compiled for
``sm_90a`` into ``_build/`` beside this file (listed in .gitignore), under a
name keyed by the file's name and a hash of its source and flags, and loaded
with ctypes.  ``build_all`` compiles every kernel at once, one nvcc process
per source, all started together.  A failed build raises; nothing
falls back to a plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

KERNEL_DIR = Path(__file__).resolve().parent
CSRC_DIR = KERNEL_DIR / "csrc"
BUILD_DIR = KERNEL_DIR / "_build"
REPO_ROOT = KERNEL_DIR.parents[2]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class Kernel:
    """One hand-written CUDA kernel: its source, its C symbol and ctypes
    signature, the TPU kernel it replaces, and a count of launches.

    ``launches`` is raised by one in the wrapper right where it launches
    the kernel, and nowhere else."""

    def __init__(
        self,
        name: str,
        source: str,
        symbol: str,
        argtypes: Sequence,
        replaces: str,
    ):
        self.name = name
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.route = "cuda"
        self.launches = 0
        self.ptxas_log = ""
        self._fn = None

    @property
    def source_rel(self) -> str:
        return str(self.source.relative_to(REPO_ROOT))

    def _so_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def _load(self, so: Path) -> None:
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._lib = lib  # keep the library mapped while fn is in use
        self._fn = fn

    def fn(self):
        """The loaded C entry point; builds the kernel at first use."""
        if self._fn is None:
            build_all([self])
        return self._fn

    def check(self, err: int) -> None:
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: cudaError {err}"
            )


REGISTRY: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    REGISTRY[kernel.name] = kernel
    return kernel


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_all(kernels: Optional[List[Kernel]] = None) -> Dict[str, float]:
    """Compile (if needed) and load the given kernels, all registered ones
    by default.  One nvcc process per source, started together.  Returns
    {kernel name: seconds its build took} (0.0 when it was already built)."""
    kernels = list(REGISTRY.values()) if kernels is None else kernels
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    times: Dict[str, float] = {}
    by_so: Dict[Path, List[Kernel]] = {}  # the kernels each new library holds
    for k in kernels:
        so = k._so_path()
        if so.exists():
            times[k.name] = 0.0
            continue
        if so in by_so:
            by_so[so].append(k)
            continue
        by_so[so] = [k]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
        t0 = time.perf_counter()
        p = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        procs.append((k, p, tmp, so, t0))
    for k, p, tmp, so, t0 in procs:
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {k.source_rel} (rc {p.returncode}):\n"
                f"{out}\n{err}"
            )
        os.replace(tmp, so)
        for other in by_so[so]:
            times[other.name] = time.perf_counter() - t0
            other.ptxas_log = err
    for k in kernels:
        if k._fn is None:
            k._load(k._so_path())
    return times


def stream_handle(tensor) -> int:
    """The raw cudaStream_t of PyTorch's current stream on tensor's device."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
