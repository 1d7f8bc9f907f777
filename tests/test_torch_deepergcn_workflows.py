"""DeeperGCN's explain, export and pca_only in the PyTorch port against the
JAX package, on the CPU.

- Explain: on fold 2 of the 60-patient, 5-pathway files of
  test_torch_deepergcn_protocol.py (gbm.yaml with model=deepergcn at small
  widths, f32), both packages' load_fold_state without a checkpoint, JAX's
  PRNGKey(0) parameters carried into the port through interop.py.
  integrated_gradients on 8 test patients, without raw_data (as the
  explain CLI builds its batches) and with it: (B, N, 3) attributions
  within 1e-5 of JAX's, relative to max(1, max|ref|).  pathway_attributions
  then raises the same IndexError in both (the PCA-row mapping indexes the
  3-slot node space, not the N gene rows).
- Export: export_fold raises the same ValueError in both (a (B, NODES) x
  meets the model's 3-D unpacking).
- pca_only: the GENConvs get the P pathway rows over the N-node graph.
  With pathway nodes both packages raise TypeError at the first GENConv's
  x + m, on JAX's pallas and xla backends, f32 and bf16, max and softmax;
  without them h is None and both raise AttributeError, except JAX's xla
  backend in f32, whose gather raises TypeError first (the port follows the
  pallas backend, as everywhere).
"""
import flax
import jax
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.batch import Batch as JBatch
from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.models.deepergcn import DeeperGCN as JModel
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu.train import explain as jexplain
from multilevel_gnn_tpu.train import export as jexport
from multilevel_gnn_tpu.train import predict as jpredict
from multilevel_gnn_tpu_torch.core.batch import Batch
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.interop import load_flax_params
from multilevel_gnn_tpu_torch.models.deepergcn import DeeperGCN
from multilevel_gnn_tpu_torch.train import explain, export, predict
from multilevel_gnn_tpu_torch.train.step import eval_step
from test_torch_deepergcn_model import batches, cfg_dict, fold
from test_torch_deepergcn_protocol import _load, written  # noqa: F401  (fixture)
from torch_threads import few_threads  # noqa: F401  (autouse)

TOL = 1e-5
B = 8


def _flat(params):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(params, sep="/").items()}


def _backend(name):
    prev = jspmm.get_backend()
    jspmm.set_backend(name)
    return prev


@pytest.fixture(scope="module")
def states(written):  # noqa: F811
    jc, pc, cfg = _load(written)
    prev = _backend("pallas")
    try:
        jst = jpredict.load_fold_state(jc.cfg, jc, None, 0, 2)
    finally:
        jspmm.set_backend(prev)
    pst = predict.load_fold_state(cfg, pc, None, 0, 2, device="cpu")
    load_flax_params(pst["model"], _flat(jst["params"]))
    return jc, pc, cfg, jst, pst


def _batches(jc, st, raw):
    idx = np.asarray(st["splits"]["test"])[:B]
    X = np.asarray(st["X"])[idx]
    rd = np.asarray(st["fold"].pathway_node_attr, np.float32)[idx] if raw else None
    jb = JBatch(x=jax.numpy.asarray(X), y=jax.numpy.asarray(jc.Y[idx]),
                age=jax.numpy.asarray(jc.ages[idx]), sample_mask=jax.numpy.ones(B, bool),
                raw_data=None if rd is None else jax.numpy.asarray(rd))
    pb = Batch(x=torch.as_tensor(X), y=torch.as_tensor(np.asarray(jc.Y)[idx]),
               age=torch.as_tensor(np.asarray(jc.ages)[idx]),
               sample_mask=torch.ones(B, dtype=torch.bool),
               raw_data=None if rd is None else torch.as_tensor(rd))
    return jb, pb


@pytest.mark.parametrize("raw", [False, True], ids=["cli_batch", "raw_data"])
def test_integrated_gradients_match_jax(states, raw):
    jc, pc, cfg, jst, pst = states
    jb, pb = _batches(jc, jst, raw)
    prev = _backend("pallas")
    try:
        jig = np.asarray(jexplain.integrated_gradients(jst["model"], jst["params"], jb,
                                                       jst["ctx"], steps=4))
    finally:
        jspmm.set_backend(prev)
    pig = explain.integrated_gradients(pst["model"], pb, pst["ctx"], steps=4).numpy()
    assert pig.shape == jig.shape == (B, pst["cfg"].node_num, 3)
    assert np.abs(pig - jig).max() <= TOL * max(1.0, np.abs(jig).max())
    with pytest.raises(IndexError) as je:
        jexplain.pathway_attributions(jig, jst["ctx"], jc.n_pathways)
    with pytest.raises(IndexError) as pe:
        explain.pathway_attributions(pig, pst["ctx"], pc.n_pathways)
    assert str(pe.value) == str(je.value)


def test_export_raises_as_jax_does(states):
    jc, pc, cfg, jst, pst = states
    with pytest.raises(ValueError) as je:
        jexport.export_fold(jc.cfg, jc, None, 0, 2)
    with pytest.raises(ValueError) as pe:
        export.export_fold(cfg, pc, None, 0, 2, device="cpu")
    assert str(pe.value) == str(je.value) == "not enough values to unpack (expected 3, got 2)"


PCA_ONLY = [dict(pathway_global_node=g, gcn_aggr=a, compute_dtype=d)
            for g in (True, False) for a in ("max", "softmax") for d in (None, "bfloat16")]


@pytest.mark.parametrize("case", PCA_ONLY, ids=lambda c: "-".join(
    [("pathway_nodes" if c["pathway_global_node"] else "no_pathway_nodes"),
     c["gcn_aggr"], c["compute_dtype"] or "f32"]))
def test_pca_only_raises_as_jax_does(case):
    f = fold()
    kw = dict(case, pca_only=True)
    jb, pb = batches(f)
    jm = JModel(JConfig.from_dict(cfg_dict(**kw)))
    raised = {}
    for be in ("pallas", "xla"):
        prev = _backend(be)
        try:
            with pytest.raises(Exception) as e:
                jm.init(jax.random.PRNGKey(0), jb[0], f["jctx"], False)
            raised[be] = e.type
        finally:
            jspmm.set_backend(prev)
    model = DeeperGCN(Config.from_dict(cfg_dict(**kw)), device="cpu")
    with pytest.raises(Exception) as e:
        eval_step(model, pb[0], f["pctx"])
    assert e.type is raised["pallas"]
    want = TypeError if case["pathway_global_node"] else AttributeError
    assert raised["pallas"] is want
    xla_f32_gather = not case["pathway_global_node"] and case["compute_dtype"] is None
    assert raised["xla"] is (TypeError if xla_f32_gather else want)
