"""What decides `correct`: the timed path's own outputs against the plain
reference (configs/<reference>.py), run once the window has closed, the
peak memory has been read and the program's state freed.

serve: a sample of the window's requests, drawn from the seed; each
patient's score as the logit log(p0 / p1) of the served probability, and
each request's loss.
  logit_gap  max |logit - reference logit| / max |reference logit|, over
             the sampled patients
  loss_gap   max |loss - reference loss| / reference loss, over the
             sampled requests
  missing    sampled requests whose answer never came or is not finite
train: the first steps of the set-up's run_fold call (the window's own
call, model and feed), followed by the reference from the same weights,
rows and dropout masks.
  loss1_gap  the first step's |loss - reference| / |reference| (the two
             sides part after the first update; see PERF.md)
  loss_gap   max over the steps of |loss - reference| / |reference|
  grad_gap   the first gradient (Adam's first moment after one step over
             1 - beta1): max over leaves of | |g| - |g_ref| | / max(|g_ref|,
             the median leaf's |g_ref|)
  update_gap the parameters' change after the steps, the same measure,
             over the leaves whose reference gradient is at least a
             thousandth of the median leaf's (the others move by Adam's
             round-off alone)
Each number has its limit in limits/<cell>.json, set from the port's
readings on a dozen seeds and more and from the control's and the
faults' (PERF.md gives them); a run is correct when every number is
finite and within its limit."""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from harness import inputs


def logits_of(prob0: np.ndarray) -> np.ndarray:
    p = np.clip(np.asarray(prob0, np.float64), 1e-12, 1 - 1e-12)
    return np.log(p) - np.log1p(-p)


def serve_numbers(ref, weights: Dict, served: List, requests: List, sut: Dict,
                  seed: int, sample: int) -> Dict[str, float]:
    dev = ref.dev
    rng = inputs.numpy_rng(seed, inputs.SAMPLE)
    pick = rng.choice(len(served), min(sample, len(served)), replace=False)
    X, Y, ages = sut["X"], sut["Y"], sut["ages"]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    d_logit, ref_logit, loss_gaps, missing = [], [], [], 0
    for j in pick:
        req, prob, loss = served[j]
        rows = requests[req]
        prob = np.asarray(prob, np.float64)
        if len(prob) != len(rows) or not np.all(np.isfinite(prob)) or not math.isfinite(loss):
            missing += 1
            continue
        p_ref, l_ref = ref.evaluate(weights, t(X[rows]), t(Y[rows]), t(ages[rows]))
        lr = logits_of(p_ref[:, 0].double().cpu().numpy())
        d_logit.append(np.abs(logits_of(prob) - lr))
        ref_logit.append(np.abs(lr))
        loss_gaps.append(abs(loss - float(l_ref)) / max(abs(float(l_ref)), 1e-12))
    if not d_logit:
        return {"logit_gap": math.inf, "loss_gap": math.inf, "missing": float(missing)}
    return {"logit_gap": float(np.max(np.concatenate(d_logit))
                               / max(np.max(np.concatenate(ref_logit)), 1e-12)),
            "loss_gap": float(max(loss_gaps)), "missing": float(missing)}


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """{leaf: | |got| - |want| | / max(|want|, median |want|)}."""
    names = [n for n in want if keep is None or n in keep]
    norms = {n: float(torch.linalg.vector_norm(want[n].double())) for n in names}
    med = float(np.median(list(norms.values())))
    return {n: abs(float(torch.linalg.vector_norm(got[n].double())) - norms[n])
            / max(norms[n], med, 1e-30) for n in names}


def leaf_gap(got, want, keep=None) -> float:
    """The worst leaf's gap (leaf_gaps)."""
    return max(leaf_gaps(got, want, keep).values())


def moved_leaves(grads: Dict[str, torch.Tensor]) -> set:
    """Leaves whose reference gradient is at least 1e-3 of the median leaf's."""
    norms = {n: float(torch.linalg.vector_norm(g.double())) for n, g in grads.items()}
    med = float(np.median(list(norms.values())))
    return {n for n, v in norms.items() if v >= 1e-3 * med}


def train_numbers(losses: List[float], grads: Dict, params: Dict, p0: Dict,
                  ref_losses: List[float], ref_grads: Dict, ref_params: Dict
                  ) -> Dict[str, float]:
    if len(losses) < len(ref_losses) or grads is None or params is None:
        return {"loss_gap": math.inf, "grad_gap": math.inf, "update_gap": math.inf}
    loss_gap = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses, ref_losses))
    cpu = lambda d: {k: v.detach().double().cpu() for k, v in d.items()}  # noqa: E731
    g, rg, p, rp, q0 = cpu(grads), cpu(ref_grads), cpu(params), cpu(ref_params), cpu(p0)
    change = {n: p[n] - q0[n] for n in rp}
    ref_change = {n: rp[n] - q0[n] for n in rp}
    gg = leaf_gaps(g, rg)
    ug = leaf_gaps(change, ref_change, moved_leaves(rg))
    worst = lambda d: sorted(d, key=d.get, reverse=True)[:3]  # noqa: E731
    return {"loss_gap": float(loss_gap),
            "loss1_gap": abs(losses[0] - ref_losses[0]) / max(abs(ref_losses[0]), 1e-12),
            "grad_gap": max(gg.values()), "update_gap": max(ug.values()),
            "grad_gap_median": float(np.median(list(gg.values()))),
            "update_gap_median": float(np.median(list(ug.values()))),
            "step_loss_gaps": [abs(a - b) / max(abs(b), 1e-12)
                               for a, b in zip(losses, ref_losses)],
            "worst_grad_leaves": {n: gg[n] for n in worst(gg)},
            "worst_update_leaves": {n: ug[n] for n in worst(ug)}}


def judge(numbers: Dict, limits: Dict[str, float]) -> bool:
    return all(math.isfinite(numbers.get(k, math.inf)) and numbers[k] <= lim
               for k, lim in limits.items())
