"""The port's fold-parallel CV of DeeperGCN (train/fold_parallel.py) on the
CPU.

Against the JAX package's run_experiment_foldparallel (its per-step arm:
DeeperGCN's batches carry the fold's pathway node attrs, so JAX takes no
one-dispatch arm), on the reference-format files of
test_torch_deepergcn_protocol.py (60 patients, 5 pathways; f32, dropout
off, 2 GENConv layers), each unit starting from JAX's initial parameters
(torch_fold_parallel.JaxUnitInit): gcn_aggr softmax and max, pooled AUC /
ACC within rtol 1e-5, atol 1e-6; every valid and test score of every unit
and epoch within 1e-5 (softmax) or MAX_TIE_RESIDUE (max: ties at eps
that the two packages' GEMMs break differently, ROADMAP section 3, R2).

JAX's fold-parallel leaves run_fold's apply_init_weight out
(fold_parallel.py:170-192): with all_init on, its fold-parallel and
sequential drivers differ; with it off they agree.  The port reproduces
both: each arm equal to JAX's from JAX's inits, and its own two arms
differ with all_init on and agree with it off.

Against the port's sequential run_experiment with dropout on (gbm.yaml's
0.25, all_init off) on the synthetic cohort of test_torch_fold_parallel.py.
Also: the first stacked step's per-unit gradients against each unit's own
step (within 1e-5 relative) and its K1 / K3 calls as one unit's step's;
the stacked edge-id lookup plan against the
units' own (plain K1, equal); the train CLI's --fold-parallel with
model=deepergcn; checkpoint, resume and predict.
"""
import dataclasses
import json
from collections import Counter

import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.train import driver as jdriver
from multilevel_gnn_tpu.train import fold_parallel as jfp
from multilevel_gnn_tpu_torch.core.batch import stack_contexts
from multilevel_gnn_tpu_torch.ops import spmm
from multilevel_gnn_tpu_torch.ops.kernels.segment_sum import CSRPlan, segment_spmm_csr_plain
from multilevel_gnn_tpu_torch.train import checkpoint as C
from multilevel_gnn_tpu_torch.train import cli, driver
from multilevel_gnn_tpu_torch.train import fold_parallel as fp
from multilevel_gnn_tpu_torch.train.predict import load_fold_state, predict_fold

from test_torch_deepergcn_protocol import MAX_TIE_RESIDUE, InitCarrier, _load, written  # noqa: F401
from torch_fold_parallel import (
    DGCN, GBM, JaxUnitInit, ScoreSpy, check, first_step_grads_match, stacked_first_step,
    synthetic, tiny, unit_step_grads)
from torch_threads import few_threads  # noqa: F401  (autouse)

TOL = 1e-5


@pytest.mark.parametrize("aggr", ["softmax", "max"])
def test_foldparallel_matches_jax(written, aggr, monkeypatch):  # noqa: F811
    jc, pc, cfg = _load(written, gcn_aggr=aggr)
    assert cfg.all_init and not (cfg.dropout or cfg.feature_drop)
    carrier = JaxUnitInit(monkeypatch)
    scores = ScoreSpy(monkeypatch)
    jout = jfp.run_experiment_foldparallel(jc.cfg, jc)
    assert jout["arm"] == "per-step" and len(carrier.params) == 5
    pout = fp.run_experiment_foldparallel(cfg, pc, device="cpu")
    assert not carrier.params and pout["units"] == jout["units"] == 5
    check(jout, pout)
    # valid and test scores of 5 units x 2 epochs
    assert len(scores.jax) == 20
    assert scores.max_abs_diff() <= (TOL if aggr == "softmax" else MAX_TIE_RESIDUE)


def _pooled(out):
    e = out["check_epochs"][-1]
    return tuple(out[k][e] for k in ("auc", "auc_by_loss", "auc_by_epoch", "acc"))


def test_jax_foldparallel_skips_deepergcn_init_weight(written, monkeypatch):  # noqa: F811
    """all_init on: JAX's fold-parallel and sequential pooled scores differ,
    and the port's arms equal JAX's from JAX's inits (the sequential one's
    after apply_init_weight, read by test_torch_deepergcn_protocol's
    InitCarrier) while differing from each other from the port's own;
    all_init off: both packages' arms agree."""
    out = {}
    for init in (True, False):
        jc, pc, cfg = _load(written, gcn_aggr="softmax", all_init=init)
        with monkeypatch.context() as m:
            JaxUnitInit(m)
            out["jax_fp", init] = jfp.run_experiment_foldparallel(jc.cfg, jc)
            out["port_fp_carried", init] = fp.run_experiment_foldparallel(cfg, pc, device="cpu")
        with monkeypatch.context() as m:
            InitCarrier(m)
            out["jax_seq", init] = jdriver.run_experiment(jc.cfg, jc)
            out["port_seq_carried", init] = driver.run_experiment(cfg, pc, device="cpu")
        out["port_fp", init] = fp.run_experiment_foldparallel(cfg, pc, device="cpu")
        out["port_seq", init] = driver.run_experiment(cfg, pc, device="cpu")
        for arm in ("fp", "seq"):
            check(out[f"jax_{arm}", init], out[f"port_{arm}_carried", init])
    assert _pooled(out["jax_fp", True]) != _pooled(out["jax_seq", True])
    assert _pooled(out["port_fp", True]) != _pooled(out["port_seq", True])
    check(out["jax_seq", False], out["jax_fp", False])
    check(out["port_seq", False], out["port_fp", False])


@pytest.mark.parametrize("aggr", ["max", "softmax"])
def test_foldparallel_matches_sequential_with_dropout(aggr):
    cfg = tiny(**DGCN, gcn_aggr=aggr)
    assert cfg.dropout == 0.25 and cfg.feature_drop and not cfg.all_init
    cohort = synthetic(cfg)
    seq = driver.run_experiment(cfg, cohort, device="cpu")
    par = fp.run_experiment_foldparallel(cfg, cohort, device="cpu")
    assert par["units"] == 5 and par["arm"] == "per-step"
    check(seq, par)


@pytest.mark.parametrize("readout", ["maxpool", "MSA"])
def test_first_stacked_step_gradients_match_units(readout):
    """gcn_aggr max, dropout on (the MSA readout's attention dropout is
    drawn per unit too, broadcast over the batch and the heads).  The
    attention's key bias shifts each query's logits by one constant, which
    its softmax cancels: its gradient is rounding only."""
    cfg = tiny(**DGCN, gcn_aggr="max", pathway_readout=readout,
               hidden_channels=16 if readout == "MSA" else 8)
    zero = ("readout_msa.MultiHeadDotProductAttention_0.key.bias",)
    assert first_step_grads_match(cfg, synthetic(cfg), zero=zero) <= 1e-5


@pytest.mark.parametrize("aggr", ["max", "softmax"])
def test_stacked_step_calls_each_op_as_one_units_step(aggr, monkeypatch):
    """K1 and K3 (on the CPU their plain versions, counted where ops/spmm.py
    picks them) run as often in the first stacked step of five units as in
    one unit's own step: the edge-id lookup's backward,
    segment_softmax_weights' sums and the gather backwards each fold every
    unit into one call."""
    calls = Counter()
    for name in ("_k1", "_k3"):
        pick = getattr(spmm, name)

        def counted_pick(plain, pick=pick, name=name):
            fn = pick(plain)

            def counted(*a, **k):
                calls[name] += 1
                return fn(*a, **k)

            return counted

        monkeypatch.setattr(spmm, name, counted_pick)
    cfg = tiny(**DGCN, gcn_aggr=aggr)
    units, _, _ = stacked_first_step(cfg, synthetic(cfg))
    stacked = dict(calls)
    calls.clear()
    unit_step_grads(units[0])
    L = cfg.num_layers
    # forward K3 a layer (max) or two K1 sums a layer (softmax); backward K1
    # as each layer's gather_src and as the lookup
    want = ({"_k3": L, "_k1": L + 1} if aggr == "max" else {"_k1": 2 * L + L + 1})
    assert stacked == dict(calls) == want


def test_stacked_edge_id_lookup_equals_units():
    """stack_contexts keeps each unit's edge ids (padded to the stacked edge
    stride) and stacks their lookup plans over U * V table rows: gather_rows
    under torch.vmap and its backward (plain K1 over the stacked plan) equal
    the units' own lookups and backwards."""
    cfg = tiny(**DGCN)
    cohort = synthetic(cfg)
    ctxs = []
    for f in range(3):
        tr, _, _ = driver.fold_indices(cohort.labels(), cfg, f)
        ctxs.append(driver.fold_setup(cfg, cohort, tr, f, device="cpu")[1].ctx)
    sctx = stack_contexts(ctxs)
    V = ctxs[0].edge_id_gather.n_rows
    E = sctx.graph.fields["senders"].shape[1]
    plan = sctx.view.edge_id_gather
    assert plan.n_rows == 3 * V and plan.units == 3
    assert sctx.fields["edge_ids"].shape == (3, E)
    rng = np.random.RandomState(0)
    tables = torch.from_numpy(rng.randn(3, V, 5).astype(np.float32)).requires_grad_(True)
    cot = torch.from_numpy(rng.randn(3, E, 5).astype(np.float32))
    out = torch.vmap(lambda t, ids: spmm.gather_rows(t, ids, plan))(tables, sctx.fields["edge_ids"])
    out.backward(cot)
    for u, c in enumerate(ctxs):
        t = tables[u].detach().clone().requires_grad_(True)
        own = spmm.gather_rows(t, c.edge_ids, c.edge_id_gather)
        own.backward(cot[u, : own.shape[0]])
        assert torch.equal(out[u, : own.shape[0]], own)
        assert torch.equal(tables.grad[u], t.grad)
    # the stacked plan's rows are the units' own rows, in order
    g = torch.from_numpy(rng.randn(3 * E, 4).astype(np.float32))
    ones = torch.ones(3 * E)
    want = torch.cat([segment_spmm_csr_plain(g[u * E:(u + 1) * E], ones[:E], c.edge_id_gather)
                      for u, c in enumerate(ctxs)])
    assert torch.equal(segment_spmm_csr_plain(g, ones, plan), want)


def test_edge_lookup_refuses_a_plan_over_other_table_rows():
    """DeeperGCN's edge-id lookup takes a plan over V table rows a unit: one
    unit's plan, or U * V rows stacked over U units; an unstacked plan over
    U * V rows (another vocabulary) raises ValueError."""
    cfg = tiny(**DGCN)
    cohort = synthetic(cfg)
    tr, _, _ = driver.fold_indices(cohort.labels(), cfg, 0)
    fcfg, fold, _ = driver.fold_setup(cfg, cohort, tr, 0, device="cpu")
    ctx = fold.ctx
    model = driver._new_model(fcfg, ctx, 0, init_weight=False)
    V = ctx.edge_id_gather.n_rows
    assert model._edge_features(ctx).shape[0] == ctx.edge_ids.shape[0]
    stacked = stack_contexts([ctx, ctx]).view.edge_id_gather
    assert stacked.n_rows == 2 * V and model._edge_features(
        dataclasses.replace(ctx, edge_id_gather=stacked)) is not None
    wide = CSRPlan.gather(ctx.edge_ids.numpy(), 2 * V)
    with pytest.raises(ValueError, match=f"edge ids over {V} table rows"):
        model._edge_features(dataclasses.replace(ctx, edge_id_gather=wide))


def test_cli_fold_parallel_deepergcn(capsys):
    res = cli.main(["--config", GBM, "--synthetic", "--debug", "--device", "cpu",
                    "--fold-parallel", "--set", "model=deepergcn", "epochs=2",
                    "hidden_channels=8", "num_layers=2", "node_embedding_dim=4"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["units"] == 5 and line["model"] == "deepergcn"
    assert line["pooled_auc"] == res["auc"][res["check_epochs"][-1]]
    assert 0.0 <= line["pooled_auc"] <= 1.0


def test_checkpoint_resume_and_predict(tmp_path):
    """ckpt_every 1: 4 epochs uninterrupted equal 2 epochs then a resume;
    predict_fold scores fold 1 from its per-unit checkpoint, equal to the
    model with that checkpoint loaded scored in memory."""
    cfg = tiny(**DGCN, gcn_aggr="max", epochs=4, ckpt_every=1)
    cohort = synthetic(cfg)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    full = fp.run_experiment_foldparallel(cfg, cohort, ckpt_dir=a, device="cpu")
    fp.run_experiment_foldparallel(cfg.replace(epochs=2), cohort, ckpt_dir=b, device="cpu")
    resumed = fp.run_experiment_foldparallel(cfg, cohort, ckpt_dir=b, resume=True,
                                             device="cpu")
    check(full, resumed, rtol=1e-6, atol=0)
    res = predict_fold(cfg, cohort, a, run_i=0, fold_i=1, split="test", device="cpu")
    st = load_fold_state(cfg, cohort, None, 0, 1, device="cpu")
    st["model"].load_state_dict(C.load_checkpoint(f"{a}/run0_fold1", 4)[0]["model"])
    mem = predict_fold(cfg, cohort, None, run_i=0, fold_i=1, split="test", model=st["model"],
                       device="cpu")
    assert len(res["prob"]) > 0 and res["prob"] == mem["prob"]
    assert np.isfinite(np.asarray(res["prob"])).all()
