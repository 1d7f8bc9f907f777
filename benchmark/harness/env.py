"""Process settings made before numpy or torch is imported: the host's
CPU threads fixed to one number, and the build and kernel caches kept at
fixed paths inside the checkout."""
from __future__ import annotations

import os
from pathlib import Path

# The harness's process runs the host side of every cell on this many CPU
# threads: torch's intra-op pool, OpenMP and BLAS.
CPU_THREADS = 1

ROOT = Path(__file__).resolve().parents[2]
CACHE = ROOT / "benchmark" / "_cache"

_THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "NUMEXPR_NUM_THREADS", "VECLIB_MAXIMUM_THREADS")


def pin_process() -> None:
    """Set the thread counts and cache directories in the environment.
    Call before numpy or torch is imported; torch.set_num_threads follows
    once torch is loaded (see threads_after_import)."""
    for var in _THREAD_VARS:
        os.environ[var] = str(CPU_THREADS)
    # caches the port's libraries could fill: fixed directories inside the
    # checkout, so a second run of a cell finds what the first one built
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    # a library that would load JAX by itself is kept from doing so
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def threads_after_import() -> None:
    import torch

    torch.set_num_threads(CPU_THREADS)
    try:
        torch.set_num_interop_threads(CPU_THREADS)
    except RuntimeError:  # already set in this process
        pass
