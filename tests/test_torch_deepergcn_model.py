"""DeeperGCN in the PyTorch port against the JAX package's, eval mode, on a
small gene-level fold graph: 60 genes and 8 pathway nodes, gene edges both
ways with int(weight) ids (0, 1 or 2), gene -> pathway edges with one-hot
ids counting up, genes without in-edges.  The JAX model runs on the
'pallas' backend (Pallas in interpret mode) under jit, initialised by
flax; its params go through interop.py into the port, which runs its
plain versions on the CPU.

- eval_step probabilities and loss over three batches (the last padded),
  f32, for blocks res+ / res / plain, readouts maxpool / MSA / mean, and
  the max, softmax and power aggregators: 1e-5.
- the bf16 trunk (the slice's config: res+, maxpool, max) against JAX's
  bf16: the GENConv residue of test_torch_deepergcn.py, through three
  layers, held at twice its reading (BF16_EVAL_RESIDUE).
- the options that JAX's model rejects raise when the port's is built (an
  unknown aggregator, block or readout); pca_only, which JAX runs into an
  error, is held in test_torch_deepergcn_workflows.py.

The third batch holds two padding rows, which the MSA readout's batch
statistics take in, as JAX's do.  Losses are compared relative to
max(1, |loss|): an untrained model's softmax saturates on some rows.
"""
import functools

import flax
import jax
import numpy as np
import pytest

from multilevel_gnn_tpu.core.batch import make_fold_context as j_make_ctx
from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.core.graph import Graph as JGraph
from multilevel_gnn_tpu.models.deepergcn import DeeperGCN as JModel
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu.train.driver import iter_batches as j_iter_batches
from multilevel_gnn_tpu.train.step import build_train_fns
from multilevel_gnn_tpu_torch.core.batch import make_fold_context
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.interop import load_flax_params
from multilevel_gnn_tpu_torch.models.deepergcn import DeeperGCN
from multilevel_gnn_tpu_torch.train.driver import iter_batches
from multilevel_gnn_tpu_torch.train.step import eval_step
from torch_threads import few_threads  # noqa: F401  (autouse)

NG, P, H, B, D, PATIENTS = 60, 8, 16, 4, 8, 10
N = NG + P
# bf16 eval probabilities (max|diff|) and loss (max|diff| / max(1, |loss|))
# against JAX's jitted bf16: twice the larger reading of
# tests/torch_deepergcn_report.py (4.82e-4 and 1.74e-4)
BF16_EVAL_RESIDUE = 9.7e-4


def fold_graph():
    """(ei (2, E), ea (E, 2), V) of a gene-level graph as
    Cohort.gene_level_graph builds one."""
    rng = np.random.RandomState(0)
    e = 150
    s, d = rng.randint(0, NG - 6, e), rng.randint(0, NG - 6, e)
    w = (rng.rand(e) * 2.5).astype(np.float32)
    edges = [[a, b] for a, b in zip(s, d)] + [[b, a] for a, b in zip(s, d)]
    attrs = [[x, float(int(x))] for x in w] * 2
    count = 0
    for pi in range(P):
        for g in sorted(rng.choice(NG, 9, replace=False)):
            edges.append([g, NG + pi])
            attrs.append([float(count), float(count)])
            count += 1
    return np.array(edges, np.int32).T, np.array(attrs, np.float32), count


@functools.lru_cache(maxsize=None)
def fold():
    ei, ea, V = fold_graph()
    rng = np.random.RandomState(1)
    G = 30
    match = rng.randint(-1, N, G)
    raw_ind = np.sort(rng.randint(0, 3 * P, G))
    jg = JGraph.from_edges(ei, ea, N).with_sorted_meta()
    pg = Graph.from_edges(ei, ea, N).with_sorted_meta("cpu")
    X = rng.randn(PATIENTS, N, 3).astype(np.float32)
    X[:, NG:] = 0.0
    raw = rng.randn(PATIENTS, P, 6).astype(np.float32)
    Y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, PATIENTS)]
    ages = (rng.rand(PATIENTS) * 80).astype(np.float32)
    return dict(
        V=V, X=X, raw=raw, Y=Y, ages=ages,
        jctx=j_make_ctx(jg, match, raw_ind, n_pathways=P),
        pctx=make_fold_context(pg, match, raw_ind, n_pathways=P, device="cpu",
                               edge_vocab=V),
    )


def cfg_dict(**kw):
    """gbm.yaml's DeeperGCN choices (pathway nodes, one-hot edge ids, conv
    edge encoders, node embedding, age before the readout Linear, two head
    layers) at small widths."""
    d = dict(
        model="deepergcn", hidden_channels=H, num_layers=3, node_embedding=True,
        node_embedding_dim=D, init_emb=True, node_num=N, pathway_num=P,
        pathway_global_node=True, use_edge_attr=True, global_edge="onehot",
        conv_encode_edge=True, pathway_edge_num=fold()["V"], pca_dim=2, use_age=True,
        pre_concat_age=True, pre_readout_drop=True, num_layer_head=2, batch_size=B,
        kernel_backend="pallas", feature_drop=True, dropout=0.25,
    )
    d.update(kw)
    return d


def batches(f):
    idx = np.arange(PATIENTS)
    jb = list(j_iter_batches(f["X"], f["Y"], f["ages"], idx, B, np.random.RandomState(0),
                             False, False, raw=f["raw"]))
    pb = list(iter_batches(f["X"], f["Y"], f["ages"], idx, B, "cpu", f["raw"]))
    return jb, pb


def pallas(fn):
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    try:
        return fn()
    finally:
        jspmm.set_backend(prev)


def flat_params(params):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(params, sep="/").items()}


def eval_both(**kw):
    f = fold()
    jcfg, pcfg = JConfig.from_dict(cfg_dict(**kw)), Config.from_dict(cfg_dict(**kw))
    jb, pb = batches(f)
    jm = JModel(jcfg)

    def run():
        params = jm.init(jax.random.PRNGKey(0), jb[0], f["jctx"], False)
        fns = build_train_fns(jm, jcfg)
        return params, [fns.eval_step(params, b, f["jctx"]) for b in jb]

    params, jout = pallas(run)
    model = DeeperGCN(pcfg, device="cpu")
    load_flax_params(model, flat_params(params))
    pout = [eval_step(model, b, f["pctx"]) for b in pb]
    jp = np.stack([np.asarray(p, np.float64) for p, _ in jout])
    pp = np.stack([p.numpy().astype(np.float64) for p, _ in pout])
    jl = np.array([float(l) for _, l in jout])
    pl = np.array([float(l) for _, l in pout])
    return jp, pp, jl, pl


EVAL_CASES = [
    dict(block="res+", pathway_readout="maxpool", gcn_aggr="max"),
    dict(block="res", pathway_readout="maxpool", gcn_aggr="softmax"),
    dict(block="plain", pathway_readout="maxpool", gcn_aggr="power"),
    dict(block="res+", pathway_readout="MSA", gcn_aggr="max"),
    dict(block="res+", pathway_readout=None, gcn_aggr="softmax_sum"),
]
EVAL_IDS = [f"{c['block']}-{c['pathway_readout'] or 'mean'}-{c['gcn_aggr']}" for c in EVAL_CASES]


@pytest.mark.parametrize("case", EVAL_CASES, ids=EVAL_IDS)
def test_eval_f32_matches_jax(case):
    jp, pp, jl, pl = eval_both(**case)
    assert np.isfinite(pp).all() and pp.shape == (3, B, 2)
    np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-5)
    assert np.abs(pl - jl).max() <= 1e-5 * max(1.0, np.abs(jl).max())


def test_eval_bf16_within_residue_of_jax_bf16():
    jp, pp, jl, pl = eval_both(compute_dtype="bfloat16")
    assert np.isfinite(pp).all()
    np.testing.assert_allclose(pp, jp, rtol=0, atol=BF16_EVAL_RESIDUE)
    assert np.abs(pl - jl).max() <= BF16_EVAL_RESIDUE * max(1.0, np.abs(jl).max())


@pytest.mark.parametrize("option", [dict(gcn_aggr="lstm"), dict(block="dense"),
                                    dict(pathway_readout="sum")])
def test_options_outside_the_port_raise(option):
    with pytest.raises(NotImplementedError):
        DeeperGCN(Config.from_dict(cfg_dict(**option)), device="cpu")
