"""The Kraskov (KSG) k-NN mutual-information estimator of the edge
selection (port of multilevel_gnn_tpu/utils/knnie.py:42-73 kraskov_mi,
without scipy).

The JAX package finds neighbours with scipy's cKDTree and takes scipy's
digamma.  Here the sizes are a fold's training patients by at most three
dimensions, so the Chebyshev distances are taken by brute force, and
digamma is evaluated only at positive integers, where it is exactly
-gamma + H(n - 1), the harmonic number, summed with compensation.  The
tie-breaking noise is numpy's RandomState(0), drawn in the same order (x,
then y).
"""
from __future__ import annotations

import math

import numpy as np

EULER_GAMMA = 0.57721566490153286060651209008240243


def digamma_table(top: int) -> np.ndarray:
    """digamma(m) for m = 0 .. top (NaN at 0): -gamma + H(m - 1), the
    harmonic numbers summed with Neumaier's compensation, so each is within
    an ulp or two of the exact value."""
    table = np.empty(top + 1, np.float64)
    table[0] = math.nan
    s = c = 0.0
    for m in range(1, top + 1):
        table[m] = (s + c) - EULER_GAMMA
        term = 1.0 / m
        t = s + term
        c += (s - t) + term if abs(s) >= term else (term - t) + s
        s = t
    return table


def _chebyshev(a: np.ndarray) -> np.ndarray:
    """(n, n) max-norm distances between the rows of a (n, d)."""
    return np.abs(a[:, None, :] - a[None, :, :]).max(axis=-1)


def kraskov_mi(x: np.ndarray, y: np.ndarray, k: int = 5) -> float:
    """KSG estimator I(X;Y), x: (n, dx), y: (n, dy); natural log units,
    floored at 0 (knnie.py:42-73)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    if len(x) != len(y):
        raise ValueError("x and y need one row per sample")
    n = len(x)
    if n <= k:
        return 0.0
    rng = np.random.RandomState(0)
    x = x + 1e-10 * rng.standard_normal(x.shape)
    y = y + 1e-10 * rng.standard_normal(y.shape)
    z = np.concatenate([x, y], axis=1)
    # distance to the k-th neighbour, self (distance 0) counted as the 0th
    eps = np.partition(_chebyshev(z), k, axis=1)[:, k]
    # neighbours strictly inside eps in each marginal (cKDTree's
    # query_ball_point at eps - 1e-12, closed ball), self excluded
    r = (eps - 1e-12)[:, None]
    nx = (_chebyshev(x) <= r).sum(axis=1) - 1
    ny = (_chebyshev(y) <= r).sum(axis=1) - 1
    psi = digamma_table(n)
    mi = psi[k] + psi[n] - np.mean(psi[nx + 1] + psi[ny + 1])
    return float(max(mi, 0.0))
