"""edge_type 'merge' (the shared GNN stack over two graphs) and the PPI /
merge protocols, port against the JAX package on the CPU.

- The merge model on the small slice fold of test_torch_slice.py (its
  primary graph on the composed path) with a secondary graph in
  gene-index space, both ways, self-looped and padded, as Cohort.merge_graph2 builds it; JAX's
  params (flax init) through interop.py: eval probabilities and loss per
  batch, f32 atol 1e-5 and bf16 trunk against JAX's bf16 trunk atol 1e-5;
  five train steps' losses (dropout off), f32 atol 1e-5 and bf16 1e-4.
- run_experiment, 1 run x 5 folds x 5 epochs, on files written by
  write_reference_format and write_string_ppi (50 patients, 4 pathways),
  under edge_type ppi and merge, each fold's JAX init carried in: every
  fold's test scores within 1e-5 and the pooled AUC / ACC equal
  (test_torch_experiment.py's checks).
"""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.core.graph import Graph as JGraph
from multilevel_gnn_tpu.data import loaders as jloaders
from multilevel_gnn_tpu.models.multilevel_gnn import MultilevelGNN as JModel
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu.train import step as jstep
from multilevel_gnn_tpu.train.driver import iter_batches as j_iter_batches
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.data import loaders
from multilevel_gnn_tpu_torch.data.synthetic import write_reference_format, write_string_ppi
from multilevel_gnn_tpu_torch.interop import load_flax_params
from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
from multilevel_gnn_tpu_torch.train import step as pstep
from multilevel_gnn_tpu_torch.train.driver import iter_batches

from test_torch_experiment import GBM, KW, _experiment_matches
from test_torch_slice import B, G, P, _cfg_dict, fold  # noqa: F401  (fixture)
from torch_threads import few_threads  # noqa: F401  (autouse)

TOL = 1e-5
TOL_BF16_LOSS = 1e-4
STEPS = 5


@pytest.fixture(scope="module")
def merge_fold(fold):
    """The slice fold with a secondary graph over gene indices; the
    primary graph without its window plan (the composed path: the windowed
    one is held in test_torch_slice.py, and JAX's interpret mode of it is
    this file's largest cost)."""
    rng = np.random.RandomState(9)
    n = fold["n"]
    pairs = rng.randint(0, n // 3, (2, 150))
    ei = np.concatenate([pairs, pairs[::-1]], axis=1)
    attr = rng.rand(ei.shape[1]).astype(np.float32)
    pad = ei.shape[1] + n + 9
    jg2 = JGraph.from_edges(ei, attr, n).with_self_loops().pad_edges_to(pad).with_sorted_meta()
    pg2 = Graph.from_edges(ei, attr, n).with_self_loops().pad_edges_to(pad).with_sorted_meta("cpu")
    jctx, pctx = fold["jctx"], fold["pctx"]
    return dict(fold, jctx=dataclasses.replace(
        jctx, graph=dataclasses.replace(jctx.graph, winplan=None), graph2=jg2),
        pctx=dataclasses.replace(
            pctx, graph=dataclasses.replace(pctx.graph, winplan=None), graph2=pg2))


def _flat(tree):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _cfgs(bf16, **kw):
    kw = dict(edge_type="merge", **kw)
    if bf16:
        kw.update(compute_dtype="bfloat16", spmm_bf16=True)
    return JConfig.from_dict(_cfg_dict(**kw)), Config.from_dict(_cfg_dict(**kw))


def merge_eval(fold, bf16):
    """[(port probs, JAX probs, port loss, JAX loss)] per batch, and the
    port model carrying JAX's params."""
    jcfg, pcfg = _cfgs(bf16)
    jb = list(j_iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B,
                             np.random.RandomState(0), False, False))
    jmodel = JModel(jcfg)
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    jspmm.set_spmm_dtype(jnp.bfloat16 if bf16 else None)
    try:
        # under jit: one compile instead of one per op of the eager init
        params = jax.jit(lambda k, b, c: jmodel.init(k, b, c, False))(
            jax.random.PRNGKey(0), jb[0], fold["jctx"])
        fns = jstep.build_train_fns(jmodel, jcfg)
        jout = [fns.eval_step(params, b, fold["jctx"]) for b in jb]
    finally:
        jspmm.set_backend(prev)
        jspmm.set_spmm_dtype(None)
    flat = _flat(params)
    # the head reads both graphs' features: twice final_channels
    assert flat["params/conv_head/Conv_0/kernel"].shape[2] == 2 * pcfg.final_channels
    model = MultilevelGNN(pcfg, fold["n"], G, device="cpu")
    load_flax_params(model, flat)
    rows = []
    for (jp, jl), b in zip(jout, iter_batches(fold["X"], fold["Y"], fold["ages"],
                                              np.arange(P), B, "cpu")):
        pp, pl = pstep.eval_step(model, b, fold["pctx"])
        rows.append((pp.numpy(), np.asarray(jp), float(pl), float(jl)))
    return rows, model


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_merge_eval_matches_jax(merge_fold, bf16):
    fold = merge_fold
    rows, model = merge_eval(fold, bf16)
    for pp, jp, pl, jl in rows:
        np.testing.assert_allclose(pp, jp, rtol=0, atol=TOL)
        assert abs(pl - jl) <= TOL
    # the secondary graph changes the result
    one = dataclasses.replace(fold["pctx"], graph2=fold["pctx"].graph)
    b0 = next(iter(iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B, "cpu")))
    assert float((pstep.eval_step(model, b0, one)[0]
                  - pstep.eval_step(model, b0, fold["pctx"])[0]).abs().max()) > 1e-6


def merge_train(fold, bf16):
    """The five steps' losses: (port, JAX)."""
    jcfg, pcfg = _cfgs(bf16, feature_drop=False, head_drop_rate=0.0, gnn_dropout=0.0,
                       lr=1e-3, weight_balance=True, pca_indep_loss=True, pca_loss=True)
    cw = np.array([1.0, 1.7], np.float32)
    jb = list(j_iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B,
                             np.random.RandomState(0), False, False))
    pb = list(iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B, "cpu"))
    jmodel = JModel(jcfg)
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    jspmm.set_spmm_dtype(jnp.bfloat16 if bf16 else None)
    try:
        fns = jstep.build_train_fns(jmodel, jcfg)
        params, opt_state = fns.init_state(jax.random.PRNGKey(0), jb[0], fold["jctx"], 3)
        flat0 = _flat(params)
        jl = []
        for i in range(STEPS):
            params, opt_state, loss = fns.train_step(
                params, opt_state, jb[i % len(jb)], fold["jctx"], jnp.asarray(cw),
                jax.random.PRNGKey(i))
            jl.append(float(loss))
    finally:
        jspmm.set_backend(prev)
        jspmm.set_spmm_dtype(None)
    model = MultilevelGNN(pcfg, fold["n"], G, device="cpu")
    load_flax_params(model, flat0)
    opt = pstep.make_optimizer(model, pcfg, 3)
    gen = torch.Generator().manual_seed(0)
    pl = [float(pstep.train_step(model, opt, pb[i % len(pb)], fold["pctx"],
                                 torch.from_numpy(cw), gen)) for i in range(STEPS)]
    return np.array(pl), np.array(jl)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_merge_five_train_steps_match_jax(merge_fold, bf16):
    pl, jl = merge_train(merge_fold, bf16)
    assert np.isfinite(pl).all() and len(set(pl.tolist())) > 1
    np.testing.assert_allclose(pl, jl, rtol=0, atol=TOL_BF16_LOSS if bf16 else TOL)


@pytest.fixture(scope="module", params=["ppi", "merge"])
def protocol(request, tmp_path_factory):
    return build_protocol(str(tmp_path_factory.mktemp(request.param)), request.param)


def build_protocol(d, edge_type):
    """The cohort written into d with STRING tables, loaded by both
    packages under gbm.yaml at test_torch_experiment.py's small widths."""
    write_reference_format(d, seed=4, cancer_type="gbm", n_patients=50, n_pathways=4)
    write_string_ppi(d, loaders.read_kegg_csv(f"{d}/kegg.csv"), seed=1, e_ppi=600,
                     cancer_type="gbm")
    paths = dict(
        mrna_path=f"{d}/gbm/raw_mrna.csv", cnv_path=f"{d}/gbm/raw_cnv.csv",
        methylation_path=f"{d}/gbm/raw_methylation.csv",
        clinical_path=f"{d}/gbm/clinical.pkl", kegg_path=f"{d}/kegg.csv",
        pathway_list_path=f"{d}/pathways.txt", edge_path=f"{d}/gbm/ppi_edges.csv",
        ppi_node_path=f"{d}/node.csv",
        grn_edge_path=f"{d}/gbm/grn_edges.tsv" if edge_type == "merge" else None)
    kw = dict(KW, edge_type=edge_type)
    jcohort = jloaders.load_cohort_from_files(cfg=JConfig.from_yaml(GBM, **kw), **paths)
    cfg = Config.from_yaml(GBM, **kw)
    cohort = loaders.load_cohort_from_files(cfg=cfg, **paths)
    return dict(dir=d, jcohort=jcohort, cohort=cohort, cfg=cfg)


def test_run_experiment_ppi_and_merge_match_jax(protocol, monkeypatch):
    c = protocol["cohort"]
    assert sum(map(len, c.edges.values())) > 100
    assert (c.edges2 is not None) == (protocol["cfg"].edge_type == "merge")
    _experiment_matches(protocol, monkeypatch)
