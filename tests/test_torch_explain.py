"""The port's explain workflow against the JAX package's, on the CPU.

- integrated_gradients on the small fold of test_torch_slice.py (f32 trunk,
  eval mode, from the same flax params, JAX on the 'pallas' path in
  interpret mode), windowed and composed: within 1e-5 x max(1, max|ref|).
  The value mask and the node embedding's outer product both carry the
  input gradient, as in JAX.
- pathway_attributions of the same attributions: exactly equal.
- the survival screen: km_curve equal; the 1-degree chi-square tail
  (erfc(sqrt(x / 2))) within 1e-12 relative of scipy.stats.chi2.sf;
  pathway_km_screen's rows equal to JAX's (pathway, group sizes, order),
  chi2 within 1e-12 relative and p within 1e-12.
"""
import dataclasses

import flax
import jax
import numpy as np
import pytest
import scipy.stats
import torch

from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.models.multilevel_gnn import MultilevelGNN as JModel
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu.train import explain as jexplain
from multilevel_gnn_tpu.train.driver import iter_batches as j_iter_batches
from multilevel_gnn_tpu.utils import survival as jsurv
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.interop import load_flax_params
from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
from multilevel_gnn_tpu_torch.train import explain
from multilevel_gnn_tpu_torch.train.driver import iter_batches
from multilevel_gnn_tpu_torch.utils import survival

from test_torch_slice import B, G, N_PATHWAYS, P, _cfg_dict, fold  # noqa: F401  (fixture)
from torch_threads import few_threads  # noqa: F401  (autouse)

STEPS = 8


@pytest.mark.parametrize("windowed", [True, False], ids=["windowed", "composed"])
def test_integrated_gradients_matches_jax(fold, windowed):
    jctx, pctx = fold["jctx"], fold["pctx"]
    if not windowed:
        jctx = dataclasses.replace(jctx, graph=dataclasses.replace(jctx.graph, winplan=None))
        pctx = dataclasses.replace(pctx, graph=dataclasses.replace(pctx.graph, winplan=None))
    kw = _cfg_dict()
    jcfg, pcfg = JConfig.from_dict(kw), Config.from_dict(kw)
    jmodel = JModel(jcfg)
    jb = next(iter(j_iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B,
                                  np.random.RandomState(0), False, False)))
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    try:
        params = jmodel.init(jax.random.PRNGKey(0), jb, jctx, False)
        jig = np.asarray(jexplain.integrated_gradients(jmodel, params, jb, jctx, steps=STEPS))
    finally:
        jspmm.set_backend(prev)
    model = MultilevelGNN(pcfg, fold["n"], G, device="cpu")
    load_flax_params(model, {k: np.asarray(v) for k, v in
                             flax.traverse_util.flatten_dict(params, sep="/").items()})
    model.train()
    pb = next(iter(iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B, "cpu")))
    pig = explain.integrated_gradients(model, pb, pctx, steps=STEPS)
    assert model.training  # restored after the eval-mode passes
    assert pig.shape == jig.shape and np.abs(jig).max() > 0
    tol = 1e-5 * max(1.0, float(np.abs(jig).max()))
    np.testing.assert_allclose(pig.numpy(), jig, rtol=0, atol=tol)
    # with the value mask off, the gradient takes only the embedding's path
    # and differs: the mask's path is part of the result
    off = MultilevelGNN(pcfg.replace(value_att_mask=False), fold["n"], G, device="cpu")
    off.load_state_dict(model.state_dict())
    assert not torch.allclose(explain.integrated_gradients(off, pb, pctx, steps=STEPS), pig)


def test_pathway_attributions_equal(fold):
    att = np.random.RandomState(2).randn(B, fold["n"]).astype(np.float32)
    want = jexplain.pathway_attributions(att, fold["jctx"], N_PATHWAYS)
    got = explain.pathway_attributions(torch.from_numpy(att), fold["pctx"], N_PATHWAYS)
    np.testing.assert_array_equal(got, want)


def _survival(seed, n=40, k=7):
    rng = np.random.RandomState(seed)
    times = np.round(rng.exponential(20.0, n), 0)  # ties at equal months
    events = (rng.rand(n) < 0.7).astype(int)
    scores = rng.rand(n, k)
    scores[:, 3] = 1.0  # one pathway whose split leaves a group empty
    return scores, times, events, [f"hsa{i:05d}" for i in range(k)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_km_screen_matches_jax(seed):
    scores, times, events, names = _survival(seed)
    for a, b in zip(survival.km_curve(times, events), jsurv.km_curve(times, events)):
        np.testing.assert_array_equal(a, b)
    want = jsurv.pathway_km_screen(scores, times, events, names)
    got = survival.pathway_km_screen(scores, times, events, names)
    assert len(got) == len(want) == len(names) - 1
    for g, w in zip(got, want):
        assert (g["pathway"], g["n_high"], g["n_low"]) == (w["pathway"], w["n_high"], w["n_low"])
        assert abs(g["chi2"] - w["chi2"]) <= 1e-12 * max(1.0, abs(w["chi2"]))
        assert abs(g["p"] - w["p"]) <= 1e-12
    x = np.concatenate([np.linspace(0, 40, 401), [1e-9, 1e-3, 3.841458820694124]])
    for v in x:
        ref = scipy.stats.chi2.sf(v, df=1)
        assert abs(survival.chi2_sf_1(float(v)) - ref) <= 1e-12 * max(ref, 1e-300), v
