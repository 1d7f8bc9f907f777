"""The serving slice of the PyTorch port against the JAX MultilevelGNN.

A small cohort-like fold (3*gene+omics interleave, community-banded gene
edges + hub edges + cross-omics edges, self loops, padding edges) with the
windowed plan attached (with_window_meta(perm_group=3) on both sides,
window small enough to leave residual edges).  The JAX model runs on the
'pallas' backend (Pallas in interpret mode), initialised by flax; its
params go through interop.py into the port, which runs its plain versions
on the CPU.

Checked for several batches (the last one padded): eval-mode
probabilities and eval_step loss, and the evaluate() AUC/ACC.
Tolerances:
  f32 trunk:  atol = 1e-5 (probabilities and loss).
  bf16 trunk (compute_dtype bfloat16, spmm_bf16), against JAX's bf16 trunk:
        atol = 1e-5 (probabilities, loss and the first batch's pathway
        image; read 3.0e-7 and 7.5e-9 in the parity report).
  AUC / ACC (f32): equal.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.batch import make_fold_context as j_make_ctx
from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.core.graph import Graph as JGraph
from multilevel_gnn_tpu.models.multilevel_gnn import MultilevelGNN as JModel
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu.train.driver import evaluate as j_evaluate
from multilevel_gnn_tpu.train.driver import iter_batches as j_iter_batches
from multilevel_gnn_tpu.train.step import build_train_fns
from multilevel_gnn_tpu_torch.core.batch import make_fold_context
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.data.synthetic import make_cohort_topology
from multilevel_gnn_tpu_torch.interop import flax_key_to_torch, load_flax_params
from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
from multilevel_gnn_tpu_torch.train.driver import evaluate, iter_batches
from multilevel_gnn_tpu_torch.train.predict import predict_patients
from multilevel_gnn_tpu_torch.train.step import eval_step
from torch_threads import few_threads  # noqa: F401  (autouse)

N_GENES, N_PATHWAYS, G, B, P = 120, 6, 300, 4, 10
TOL_BF16 = 1e-5  # bf16 trunk against JAX's bf16 trunk
WIN = dict(perm_group=3, Wb=128, nwin=1)


def _cfg_dict(**kw):
    d = dict(
        model="multilevel_gnn", gnn_name="sage", gnn_act="leakyrelu",
        num_layers=2, hidden_channels=16, final_channels=8,
        node_embedding=True, node_embedding_dim=8, node_num=N_GENES,
        pathway_num=N_PATHWAYS, pca_dim=2, pathway_pool_dim=4, pca_pool_dim=2,
        conv_channel_list=[8, 16], conv_kernel_list=[1, 1], head_dim=16,
        use_age=True, value_att_mask=True, mutual_info_mask=True,
        pca_match_mask=True, weighted_edge=True, feature_drop=True,
        batch_size=B, kernel_backend="pallas", windowed_spmm=True,
    )
    d.update(kw)
    return d


@pytest.fixture(scope="module")
def fold():
    rng = np.random.RandomState(0)
    send, recv, n = make_cohort_topology(
        rng, n_genes=N_GENES, e_ppi=1200, community=20
    )
    attr = rng.rand(len(send)).astype(np.float32)
    match = rng.randint(-1, n, G)
    raw = np.sort(rng.randint(0, 3 * N_PATHWAYS, G))
    info = (rng.rand(G, 1) > 0.3).astype(np.float32)
    X = rng.randn(P, n).astype(np.float32)
    Y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, P)]
    ages = (rng.rand(P) * 80).astype(np.float32)
    pad_to = len(send) + n + 17  # self loops + padding edges

    jg = (JGraph.from_edges(np.stack([send, recv]), attr, n).with_self_loops()
          .pad_edges_to(pad_to).with_window_meta(**WIN).with_sorted_meta())
    pg = (Graph.from_edges(np.stack([send, recv]), attr, n).with_self_loops()
          .pad_edges_to(pad_to).with_window_meta(**WIN).with_sorted_meta("cpu"))
    assert jg.winplan is not None and pg.winplan is not None
    assert pg.winplan.n_res == int(jg.winplan.n_res) > 0
    reorder = rng.permutation(N_PATHWAYS)
    jctx = j_make_ctx(jg, match, raw, info, reorder, n_pathways=N_PATHWAYS)
    pctx = make_fold_context(pg, match, raw, info, reorder,
                             n_pathways=N_PATHWAYS, device="cpu")
    return dict(n=n, X=X, Y=Y, ages=ages, jctx=jctx, pctx=pctx)


def _run(fold, bf16, reorder=False, gnn_name="sage"):
    kw = dict(compute_dtype="bfloat16", spmm_bf16=True) if bf16 else {}
    kw["reorder_pathway"] = reorder
    kw["gnn_name"] = gnn_name
    jcfg = JConfig.from_dict(_cfg_dict(**kw))
    pcfg = Config.from_dict(_cfg_dict(**kw))
    jmodel = JModel(jcfg)
    batches = list(j_iter_batches(
        fold["X"], fold["Y"], fold["ages"], np.arange(P), B,
        np.random.RandomState(0), False, False,
    ))
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    jspmm.set_spmm_dtype(jnp.bfloat16 if bf16 else None)
    try:
        params = jmodel.init(jax.random.PRNGKey(0), batches[0], fold["jctx"], False)
        fns = build_train_fns(jmodel, jcfg)
        jout = [fns.eval_step(params, b, fold["jctx"]) for b in batches]
        jev = j_evaluate(fns, params, fold["jctx"], fold["X"], fold["Y"],
                         fold["ages"], np.arange(P), B)
        jimg = np.asarray(jmodel.apply(params, batches[0], fold["jctx"], False)[1])
    finally:
        jspmm.set_backend(prev)
        jspmm.set_spmm_dtype(None)
    flat = {
        k: np.asarray(v)
        for k, v in flax.traverse_util.flatten_dict(params, sep="/").items()
    }
    model = MultilevelGNN(pcfg, fold["n"], G, device="cpu")
    load_flax_params(model, flat)
    pbatches = list(iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B, "cpu"))
    pout = [eval_step(model, b, fold["pctx"]) for b in pbatches]
    pev = evaluate(model, fold["pctx"], fold["X"], fold["Y"], fold["ages"], np.arange(P), B)
    with torch.no_grad():
        pimg = model.eval()(pbatches[0], fold["pctx"])[1].numpy()
    jp = np.stack([np.asarray(p) for p, _ in jout]).astype(np.float64)
    jl = np.array([float(l) for _, l in jout])
    pp = np.stack([p.numpy() for p, _ in pout]).astype(np.float64)
    pl = np.array([float(l) for _, l in pout])
    return dict(jp=jp, jl=jl, pp=pp, pl=pl, jev=jev, pev=pev, model=model,
                jimg=jimg, pimg=pimg)


@pytest.fixture(scope="module")
def runs(fold):
    return {
        "f32": _run(fold, False),
        "bf16": _run(fold, True),
        "f32_reorder": _run(fold, False, reorder=True),
    }


def test_interop_keys_cover_model():
    assert flax_key_to_torch("params/gnn_0/gconv/nn/Linear_0/Dense_0/kernel") == (
        "gnn_0.gconv.nn.Linear_0.weight"
    )
    assert flax_key_to_torch("params/conv_head/Conv_1/bias") == "conv_head.Conv_1.bias"
    model = MultilevelGNN(Config.from_dict(_cfg_dict()), 3 * N_GENES, G, device="cpu")
    with pytest.raises(KeyError):
        load_flax_params(model, {"params/unknown/kernel": np.zeros((2, 2))})


@pytest.mark.parametrize("name", ["f32", "f32_reorder"])
def test_slice_f32_matches_jax(runs, name):
    r = runs[name]
    assert r["pp"].shape == (3, B, 2) and np.isfinite(r["pp"]).all()
    np.testing.assert_allclose(r["pp"], r["jp"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(r["pl"], r["jl"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("option", [
    dict(resgnn=True), dict(dense_gnn=True), dict(repeat_mask=True),
    # option3 was edge_type merge until it was ported (test_torch_merge.py)
    dict(gnn_name="gin"), dict(pca_prelinear=True),
    dict(model="multilevel_gnn_seq", only_mrna_pred=True),
    dict(used_omics="01"), dict(reduction_method="pca_svd"),
    dict(gnn_mlp_norm="batch"), dict(gnn_name="gat"),
])
def test_unported_branches_raise(option):
    cfg = Config.from_dict(_cfg_dict(**option))
    with pytest.raises(NotImplementedError):
        MultilevelGNN(cfg, 3 * N_GENES, G, device="cpu")


def test_slice_evaluate_auc_acc_equal(runs):
    r = runs["f32"]
    j_auc, j_acc, j_y, j_s, j_loss = r["jev"]
    p_auc, p_acc, p_y, p_s, p_loss = r["pev"]
    assert p_auc == j_auc and p_acc == j_acc
    np.testing.assert_array_equal(p_y, j_y)
    np.testing.assert_allclose(p_s, j_s, rtol=0, atol=1e-5)
    assert abs(p_loss - j_loss) <= 1e-5


def test_slice_bf16_within_bound(runs):
    h = runs["bf16"]
    assert np.isfinite(h["pp"]).all() and np.isfinite(h["pimg"]).all()
    np.testing.assert_allclose(h["pp"], h["jp"], rtol=0, atol=TOL_BF16)
    np.testing.assert_allclose(h["pl"], h["jl"], rtol=0, atol=TOL_BF16)
    np.testing.assert_allclose(h["pimg"], h["jimg"], rtol=0, atol=TOL_BF16)


def test_predict_patients_matches_evaluate(fold, runs):
    r = runs["f32"]
    out = predict_patients(r["model"], fold["pctx"], fold["X"], fold["Y"],
                           fold["ages"], np.arange(P))
    p_auc, p_acc, p_y, p_s, p_loss = r["pev"]
    assert out["auc"] == p_auc and out["acc"] == p_acc and out["loss"] == p_loss
    np.testing.assert_array_equal(out["prob"], p_s.astype(np.float64))
    assert len(out["patients"]) == P
