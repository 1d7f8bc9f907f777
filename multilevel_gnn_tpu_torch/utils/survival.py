"""Kaplan-Meier curves and the two-group log-rank test, and the per-pathway
survival screen of the explain workflow (port of
multilevel_gnn_tpu/utils/survival.py:15-83).

The JAX package takes the log-rank p value from scipy's chi-square
survival function; with one degree of freedom that tail is
erfc(sqrt(x / 2)), so the port needs no scipy.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


def km_curve(times: np.ndarray, events: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Kaplan-Meier estimator.  times: durations; events: 1 = event,
    0 = censored.  Returns (the distinct event times, the survival
    probability after each)."""
    times = np.asarray(times, float)
    events = np.asarray(events, int)
    order = np.argsort(times)
    times, events = times[order], events[order]
    uniq = np.unique(times[events == 1])
    surv = []
    s = 1.0
    for t in uniq:
        at_risk = np.sum(times >= t)
        d = np.sum((times == t) & (events == 1))
        s *= 1.0 - d / at_risk
        surv.append(s)
    return uniq, np.array(surv)


def chi2_sf_1(x: float) -> float:
    """P(X > x) for a chi-square variable with one degree of freedom."""
    return math.erfc(math.sqrt(x / 2.0))


def logrank_test(times_a, events_a, times_b, events_b) -> Tuple[float, float]:
    """Two-group log-rank test; returns (chi-square statistic, p value)."""
    ta, ea = np.asarray(times_a, float), np.asarray(events_a, int)
    tb, eb = np.asarray(times_b, float), np.asarray(events_b, int)
    all_t = np.unique(np.concatenate([ta[ea == 1], tb[eb == 1]]))
    o_minus_e = 0.0
    var = 0.0
    for t in all_t:
        n_a = np.sum(ta >= t)
        n_b = np.sum(tb >= t)
        d_a = np.sum((ta == t) & (ea == 1))
        d_b = np.sum((tb == t) & (eb == 1))
        n = n_a + n_b
        d = d_a + d_b
        if n < 2:
            continue
        e_a = d * n_a / n
        o_minus_e += d_a - e_a
        var += d * (n_a / n) * (n_b / n) * (n - d) / max(n - 1, 1)
    if var == 0:
        return 0.0, 1.0
    chi2 = o_minus_e**2 / var
    return float(chi2), chi2_sf_1(float(chi2))


def pathway_km_screen(
    scores: np.ndarray,
    times: np.ndarray,
    events: np.ndarray,
    pathway_names: Sequence[str],
    threshold: str = "median",
) -> List[Dict]:
    """Per pathway: split the patients at the median (or mean) of its
    score, and test the two groups' survival apart with the log-rank test.
    Returns rows sorted by p value; a pathway whose split leaves one group
    empty has no row."""
    rows = []
    for i, name in enumerate(pathway_names):
        s = scores[:, i]
        thr = np.median(s) if threshold == "median" else np.mean(s)
        hi = s >= thr
        if hi.all() or (~hi).all():
            continue
        chi2, p = logrank_test(times[hi], events[hi], times[~hi], events[~hi])
        rows.append({"pathway": name, "chi2": chi2, "p": p,
                     "n_high": int(hi.sum()), "n_low": int((~hi).sum())})
    return sorted(rows, key=lambda r: r["p"])
