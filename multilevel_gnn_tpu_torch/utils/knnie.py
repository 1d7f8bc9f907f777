"""k-NN information estimators (port of multilevel_gnn_tpu/utils/knnie.py:
vd :35-39, kraskov_mi :42-73, revised_mi :76-115, kraskov_multi_mi
:118-146, revised_multi_mi :149-176, entropy :179-191, kde_entropy
:194-203).

kraskov_mi, the estimator of the edge selection, needs no scipy: the sizes
are a fold's training patients by at most three dimensions, so its
Chebyshev distances are taken by brute force, and digamma is evaluated
only at positive integers, where it is exactly -gamma + H(n - 1), the
harmonic number, summed with compensation.  The tie-breaking noise is
numpy's RandomState(0), drawn in the same order (x, then y).  The others,
which no pipeline calls, take their neighbours from scipy's cKDTree and
scipy's digamma, gammaln and gaussian_kde, as the JAX package does, with
its reading of the reference's Python-2 entropy formulas.
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


def vd(d: int, q: float = float("inf")) -> float:
    """Log-volume of the unit l_q ball in d dimensions."""
    from scipy.special import gammaln

    if q == float("inf"):
        return d * math.log(2)
    return d * (math.log(2) + gammaln(1 + 1.0 / q)) - gammaln(1 + d / q)


def _ball_counts(a: np.ndarray, radii: np.ndarray, q: float) -> np.ndarray:
    """Points of a within radii[i] of a[i] (closed l_q ball, self included)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(a)
    return np.array([len(tree.query_ball_point(a[i], radii[i], p=q)) for i in range(len(a))])


def _kth_distance(a: np.ndarray, k: int, q: float) -> np.ndarray:
    from scipy.spatial import cKDTree

    dist, _ = cKDTree(a).query(a, k=k + 1, p=q)
    return dist[:, k]


def revised_mi(x: np.ndarray, y: np.ndarray, k: int = 5, q: float = float("inf")) -> float:
    """Revised KSG estimator I(X;Y) (Gao et al., arXiv:1604.03006): the
    joint k-NN distance under l_q, marginal counts in closed balls (radius
    + 1e-15, self excluded), log counts and the l_q ball-volume terms."""
    x, y = np.asarray(x, float), np.asarray(y, float)
    if len(x) != len(y):
        raise ValueError("x and y need one row per sample")
    n = len(x)
    if n <= k:
        return 0.0
    eps = _kth_distance(np.concatenate([x, y], axis=1), k, q)
    nx = _ball_counts(x, eps + 1e-15, q) - 1
    ny = _ball_counts(y, eps + 1e-15, q) - 1
    from scipy.special import digamma

    return float(digamma(k) + math.log(n) + vd(x.shape[1], q) + vd(y.shape[1], q)
                 - vd(x.shape[1] + y.shape[1], q) - np.mean(np.log(nx) + np.log(ny)))


def kraskov_multi_mi(x: np.ndarray, y: np.ndarray, z: np.ndarray, k: int = 5) -> float:
    """KSG multivariate I(X;Y;Z) = H(X) + H(Y) + H(Z) - H(X,Y,Z): digamma(k)
    + 2 digamma(n) - sum over the marginals of mean(digamma(open-ball
    count, self included)), the per-sample log-distance terms cancelled."""
    from scipy.special import digamma

    x, y, z = (np.asarray(a, float) for a in (x, y, z))
    if not len(x) == len(y) == len(z):
        raise ValueError("x, y and z need one row per sample")
    n = len(x)
    if n <= k:
        return 0.0
    eps = _kth_distance(np.concatenate([x, y, z], axis=1), k, np.inf)
    total = digamma(k) + 2.0 * digamma(n)
    for a in (x, y, z):
        total -= np.mean(digamma(_ball_counts(a, eps - 1e-15, np.inf)))
    return float(total)


def revised_multi_mi(x: np.ndarray, y: np.ndarray, z: np.ndarray, k: int = 5,
                     q: float = float("inf")) -> float:
    """The revised form of kraskov_multi_mi: closed-ball counts (self
    excluded), log counts and the l_q ball-volume terms."""
    from scipy.special import digamma

    x, y, z = (np.asarray(a, float) for a in (x, y, z))
    if not len(x) == len(y) == len(z):
        raise ValueError("x, y and z need one row per sample")
    n = len(x)
    if n <= k:
        return 0.0
    dims = (x.shape[1], y.shape[1], z.shape[1])
    eps = _kth_distance(np.concatenate([x, y, z], axis=1), k, q)
    out = digamma(k) + 2.0 * math.log(n) + sum(vd(d, q) for d in dims) - vd(sum(dims), q)
    for a in (x, y, z):
        out -= np.mean(np.log(_ball_counts(a, eps + 1e-15, q) - 1))
    return float(out)


def entropy(x: np.ndarray, k: int = 5, q: float = float("inf")) -> float:
    """k-NN differential entropy, -digamma(k) + digamma(n) + vd(d, q) +
    d * mean(log(k-th neighbour distance))."""
    from scipy.special import digamma

    x = np.asarray(x, float)
    n = len(x)
    if k > n - 1:
        raise ValueError("Set k smaller than num. samples - 1")
    knn_dis = np.maximum(_kth_distance(x, k, q), 1e-300)
    d = x.shape[1]
    return float(-digamma(k) + digamma(n) + vd(d, q) + d * np.mean(np.log(knn_dis)))


def kde_entropy(x: np.ndarray) -> float:
    """Resubstitution entropy of a Gaussian KDE fitted once to x (n, d)."""
    from scipy.stats import gaussian_kde

    x = np.asarray(x, float)
    dens = np.maximum(gaussian_kde(x.T).evaluate(x.T), 1e-300)
    return float(-np.mean(np.log(dens)))
