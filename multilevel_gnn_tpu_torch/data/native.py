"""Mutual-information estimators and the edge-list parser of the cohort path
(port of multilevel_gnn_tpu/data/native.py, without sklearn).

``mi_classif`` / ``mi_regression`` give sklearn's ``mutual_info_classif`` /
``mutual_info_regression`` values for continuous features: the
preprocessing of sklearn's ``_estimate_mi`` (``scale(with_mean=False)`` on
the boolean-masked copy, then the seeded 1e-10 noise, X's draw before y's)
is written out here in numpy, and the kNN counts run in the threaded C++
core ``csrc/mi_knn.cc``, compiled with the host's C++ compiler at first use
into ``_build/`` beside this file (listed in .gitignore).  A failed build
raises.

``parse_edge_tsv`` reads a (src, dst, value) edge list as the JAX package's
C++ parser does (csrc/edge_parser.cc): header line skipped, tab-separated
unless the header has no tab and a comma, a value that does not parse reads
0.0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
_SOURCE = _DIR / "csrc" / "mi_knn.cc"
_BUILD_DIR = _DIR / "_build"
_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")
_LIB = None
_LOCK = threading.Lock()


def _cxx() -> str:
    for cand in (os.environ.get("CXX", ""), "g++", "c++", "clang++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("no C++ compiler found (set CXX) to build data/csrc/mi_knn.cc")


def _lib():
    """The MI library, built at first use (keyed by a hash of the source and
    flags); thread-safe, so a prefetching thread may be the first caller."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            h = hashlib.sha256(_SOURCE.read_bytes())
            h.update(" ".join(_FLAGS).encode())
            so = _BUILD_DIR / f"mi_knn-{h.hexdigest()[:16]}.so"
            if not so.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                r = subprocess.run(
                    [_cxx(), *_FLAGS, "-o", str(tmp), str(_SOURCE)],
                    capture_output=True, text=True,
                )
                if r.returncode != 0:
                    raise RuntimeError(f"building {_SOURCE.name} failed:\n{r.stderr}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
            lib.mi_cd_batch.argtypes = [P, L, L, P, I, I, P, P, I]
            lib.mi_cd_batch.restype = None
            lib.mi_cc_batch.argtypes = [P, L, L, P, I, P, P, I]
            lib.mi_cc_batch.restype = None
            _LIB = lib
    return _LIB


def _scale_std(a: np.ndarray) -> np.ndarray:
    """sklearn.preprocessing.scale(a, with_mean=False): divide by np.nanstd
    along axis 0; a (near-)zero scale becomes 1 (_handle_zeros_in_scale).
    ``a`` is divided in place and returned."""
    s = np.nanstd(a, axis=0)
    if np.isscalar(s) or np.ndim(s) == 0:
        s = 1.0 if s == 0.0 else s
    else:
        s[s < 10 * np.finfo(s.dtype).eps] = 1.0
    a /= s
    return a


def _noised_features(x, random_state) -> Tuple[np.ndarray, np.random.RandomState]:
    """sklearn _estimate_mi's preprocessing of continuous X, the same ops in
    the same order (the boolean-mask copy is F-ordered, which sets
    np.nanstd's summation order) and the same draws."""
    if random_state is None:  # sklearn's check_random_state: the global one
        rng = np.random.mtrand._rand
    elif isinstance(random_state, (int, np.integer)):
        rng = np.random.RandomState(random_state)
    else:
        rng = random_state
    x = np.asarray(x).astype(np.float64, copy=True)
    n, g = x.shape
    cm = np.ones(g, bool)
    x[:, cm] = _scale_std(x[:, cm])
    means = np.maximum(1, np.mean(np.abs(x[:, cm]), axis=0))
    x[:, cm] += 1e-10 * means * rng.standard_normal(size=(n, g))
    return x, rng


def _digamma_table(n: int) -> np.ndarray:
    from scipy.special import digamma

    return np.ascontiguousarray(
        digamma(np.maximum(np.arange(n + 1), 1).astype(np.float64))
    )


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def mi_classif(x, y, n_neighbors: int = 3, random_state=None, n_threads: int = 0):
    """mutual_info_classif(x, y, n_neighbors=, random_state=) for continuous
    x (n, g) and a discrete y (n,); returns (g,) float64."""
    lib = _lib()
    x, _ = _noised_features(x, random_state)
    n, g = x.shape
    _, codes = np.unique(np.asarray(y), return_inverse=True)
    codes = np.ascontiguousarray(codes.reshape(-1), np.int32)
    n_classes = int(codes.max()) + 1 if n else 1
    tab = _digamma_table(n)
    x = np.ascontiguousarray(x)
    out = np.empty(g, np.float64)
    lib.mi_cd_batch(_ptr(x), n, g, _ptr(codes), n_classes, int(n_neighbors),
                    _ptr(tab), _ptr(out), int(n_threads))
    return out


def mi_regression(x, y, n_neighbors: int = 3, random_state=None, n_threads: int = 0):
    """mutual_info_regression(x, y, n_neighbors=, random_state=) for
    continuous x (n, g) and y (n,); returns (g,) float64."""
    lib = _lib()
    x, rng = _noised_features(x, random_state)
    n, g = x.shape
    y = _scale_std(np.asarray(y).astype(np.float64, copy=True))
    y += 1e-10 * np.maximum(1, np.mean(np.abs(y))) * rng.standard_normal(size=n)
    tab = _digamma_table(n)
    x = np.ascontiguousarray(x)
    y = np.ascontiguousarray(y)
    out = np.empty(g, np.float64)
    lib.mi_cc_batch(_ptr(x), n, g, _ptr(y), int(n_neighbors), _ptr(tab),
                    _ptr(out), int(n_threads))
    return out


def _value(s: str) -> float:
    try:
        return float(s)
    except ValueError:
        return 0.0


def parse_edge_tsv(path: str) -> Tuple[List[str], List[str], List[float]]:
    """(srcs, dsts, values) of an edge list file with a header line."""
    with open(path, newline="") as f:
        text = f.read()
    lines = text.split("\n")
    header = lines[0]
    delim = "\t" if "\t" in header or "," not in header else ","
    srcs, dsts, vals = [], [], []
    for line in lines[1:]:
        parts = line.split(delim, 2)
        if len(parts) < 3:
            break
        v = parts[2]
        if v.endswith("\r"):
            v = v[:-1]
        srcs.append(parts[0])
        dsts.append(parts[1])
        vals.append(_value(v))
    return srcs, dsts, vals
