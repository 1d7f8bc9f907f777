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
C++ parser does (csrc/edge_parser.cc, strtod): header line skipped,
tab-separated unless the header has no tab and a comma, a value that does
not parse reads 0.0.

``parse_csv_floats`` reads numeric CSV fields as pandas.read_csv's default
float converter does (``csrc/csv_float.cc``: pandas' precise_xstrtod, not
correctly rounded), with pandas' NA strings as NaN, for the omics CSVs
that the JAX package reads with pandas.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
_BUILD_DIR = _DIR / "_build"
_LIBS = {}
_BUILD_S = {}  # library name -> seconds its build took in this process (0.0: found built)
_LOCK = threading.Lock()
_MI_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")
_CSV_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared", "-ffp-contract=off")


def _cxx() -> str:
    for cand in (os.environ.get("CXX", ""), "g++", "c++", "clang++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("no C++ compiler found (set CXX) to build data/csrc/")


def _build(name: str, flags) -> ctypes.CDLL:
    """csrc/<name>.cc as a shared library, built at first use (keyed by a
    hash of the source and flags); thread-safe, so a prefetching thread may
    be the first caller."""
    with _LOCK:
        if name not in _LIBS:
            source = _DIR / "csrc" / f"{name}.cc"
            h = hashlib.sha256(source.read_bytes())
            h.update(" ".join(flags).encode())
            so = _BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
            t0 = time.perf_counter()
            built = not so.exists()
            if built:
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                r = subprocess.run(
                    [_cxx(), *flags, "-o", str(tmp), str(source)],
                    capture_output=True, text=True,
                )
                if r.returncode != 0:
                    raise RuntimeError(f"building {source.name} failed:\n{r.stderr}")
                os.replace(tmp, so)
            _BUILD_S[name] = time.perf_counter() - t0 if built else 0.0
            _LIBS[name] = ctypes.CDLL(str(so))
    return _LIBS[name]


def build_libraries() -> Dict[str, float]:
    """Build (if needed) and load both data libraries; returns {name:
    seconds its build took} (0.0 when it was already built)."""
    _build("mi_knn", _MI_FLAGS)
    _build("csv_float", _CSV_FLAGS)
    return dict(_BUILD_S)


def _lib():
    """The MI library (csrc/mi_knn.cc)."""
    lib = _build("mi_knn", _MI_FLAGS)
    P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.mi_cd_batch.argtypes = [P, L, L, P, I, I, P, P, I]
    lib.mi_cd_batch.restype = None
    lib.mi_cc_batch.argtypes = [P, L, L, P, I, P, P, I]
    lib.mi_cc_batch.restype = None
    return lib


def parse_csv_floats(fields) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(values float64, kind uint8, ints int64) of CSV fields (strings) as
    pandas' default float converter reads them: NA strings give NaN.  kind
    is 0 for a float, 1 for an integer within int64 (ints holds it), 2 for
    an NA string: pandas reads a column of integers and NA strings exactly,
    as int64.  A field that does not parse raises ValueError."""
    lib = _build("csv_float", _CSV_FLAGS)
    fn = lib.parse_csv_floats
    fn.argtypes = [ctypes.c_char_p, ctypes.c_long] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_long
    n = len(fields)
    buf = "\0".join(fields).encode() + b"\0"
    values = np.empty(n, np.float64)
    kind = np.empty(n, np.uint8)
    ints = np.zeros(n, np.int64)
    bad = fn(buf, n, _ptr(values), _ptr(kind), _ptr(ints))
    if bad >= 0:
        raise ValueError(f"could not convert CSV field to float: {fields[bad]!r}")
    return values, kind, ints


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
