"""The port's training batches and fold trainer against the JAX driver.

- epoch_plan with shuffle, WeightedRandomSampler weights, drop_last and
  variation aug: takes, masks and multipliers bit-equal to JAX's for one
  np.random.RandomState, which ends in the same state on both sides.
- class_weight equals Cohort.class_weight.
- run_fold for 3 epochs, dropout off, f32, on a tiny JAX synthetic cohort
  fold (make_synthetic_cohort) carried into a port context, from the same
  initial params: per-epoch valid loss within 1e-5, valid AUC equal, and
  the best-by-valid-AUC, best-by-valid-loss and per-check-epoch test
  scores within 1e-5 of JAX run_fold's.
"""
import flax
import jax
import numpy as np
import pytest

from multilevel_gnn_tpu.data.synthetic import make_synthetic_cohort
from multilevel_gnn_tpu.models.multilevel_gnn import MultilevelGNN as JModel
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu.train import driver as jdriver
from multilevel_gnn_tpu_torch.core.batch import make_fold_context
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.interop import load_flax_params
from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
from multilevel_gnn_tpu_torch.train import driver

from test_data_pipeline import gbm_like_cfg

PLAN_CASES = [
    dict(shuffle=True, drop_last=True),
    dict(shuffle=True, drop_last=False, variation_aug={"prob": 0.5, "range": 0.2}),
    dict(shuffle=False, drop_last=False,
         sampler_weights=np.linspace(0.5, 2.0, 21)),
]


@pytest.mark.parametrize("kw", PLAN_CASES, ids=["shuffle", "aug", "sampler"])
def test_epoch_plan_bit_equal(kw):
    X = np.random.RandomState(0).rand(30, 12).astype(np.float32)
    idxs = np.arange(3, 24)
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(2):  # two epochs from one stream
        a = list(jdriver.epoch_plan(X, idxs, 8, r1, **kw))
        b = list(driver.epoch_plan(X, idxs, 8, r2, **kw))
        assert len(a) == len(b) > 0
        for (ta, ma, xa), (tb, mb, xb) in zip(a, b):
            np.testing.assert_array_equal(ta, tb)
            np.testing.assert_array_equal(ma, mb)
            assert (xa is None) == (xb is None)
            if xa is not None:
                np.testing.assert_array_equal(xa, xb)
    s1, s2 = r1.get_state(), r2.get_state()
    np.testing.assert_array_equal(s1[1], s2[1])
    assert s1[2:] == s2[2:]


KW = dict(epochs=3, batch_size=8, node_embedding_dim=4, hidden_channels=8,
          final_channels=4, head_dim=16, lr=1e-3, feature_drop=False,
          head_drop_rate=0.0, gnn_dropout=0.0, pca_indep_loss=True,
          epoch_scan=False, kernel_backend="pallas")
CHECK = [1, 2, 3]


def run_jax_fold(monkeypatch):
    """JAX run_fold on the tiny fold, its per-epoch valid evaluations (a
    spy on the driver's evaluate), and the params its init draws."""
    jcfg = gbm_like_cfg(**KW)
    cohort = make_synthetic_cohort(jcfg, seed=0, n_patients=40, n_pathways=5)
    perm = np.random.RandomState(1).permutation(len(cohort.patients))  # 30
    tr, va, te = np.sort(perm[:18]), np.sort(perm[18:24]), np.sort(perm[24:])
    for idx in (va, te):
        assert 0 < cohort.labels()[idx].sum() < len(idx)  # both classes
    calls = []
    real = jdriver.evaluate

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append(out)
        return out

    monkeypatch.setattr(jdriver, "evaluate", spy)
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    try:
        res = jdriver.run_fold(jcfg, cohort, tr, va, te, 0, 0, CHECK)
        cfg, fold, X, _ = jdriver.fold_setup(jcfg, cohort, tr, 0)
        model_cfg = cfg.replace(pathway_num=cohort.n_pathways)
        init_batch = next(jdriver.iter_batches(
            X, cohort.Y, cohort.ages, tr, cfg.batch_size,
            np.random.RandomState(0), False, False))
        params = JModel(model_cfg).init(
            jax.random.PRNGKey(cfg.seed * 10_000), init_batch, fold.ctx, False)
    finally:
        jspmm.set_backend(prev)
    flat = {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(params, sep="/").items()}
    return dict(res=res, valid=calls[0::2], cohort=cohort, fold=fold, cfg=model_cfg,
                idx=(tr, va, te), flat=flat)


def run_port_fold(jf):
    """The port's run_fold on the JAX fold, carried into a port context."""
    fold, cohort = jf["fold"], jf["cohort"]
    jg = fold.ctx.graph
    assert jg.winplan is None  # a small fold takes the composed path
    mask = np.asarray(jg.edge_mask)
    g = Graph(senders=np.asarray(jg.senders), receivers=np.asarray(jg.receivers),
              edge_attr=np.asarray(jg.edge_attr), edge_mask=mask,
              n_nodes=jg.n_nodes, n_edges=int(mask.sum())).with_sorted_meta("cpu")
    ctx = make_fold_context(
        g, np.asarray(fold.ctx.gene_pca_match), np.asarray(fold.ctx.raw_indice),
        fold.info_mask, fold.reorder_idxs, pca_seed=fold.pca_seed,
        n_pathways=cohort.n_pathways, device="cpu")
    jcfg = jf["cfg"]
    pcfg = Config.from_dict({f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    model = MultilevelGNN(pcfg, g.n_nodes, ctx.num_pca_rows, device="cpu")
    load_flax_params(model, jf["flat"])
    tr, va, te = jf["idx"]
    return driver.run_fold(pcfg, ctx, cohort.X, cohort.Y, cohort.ages, tr, va, te,
                           fold.class_weight, CHECK, model=model)


@pytest.fixture(scope="module")
def jax_fold():
    mp = pytest.MonkeyPatch()
    try:
        yield run_jax_fold(mp)
    finally:
        mp.undo()


def test_class_weight_matches_cohort(jax_fold):
    tr = jax_fold["idx"][0]
    np.testing.assert_array_equal(
        driver.class_weight(jax_fold["cohort"].Y, tr, 1.0),
        jax_fold["cohort"].class_weight(tr))


def test_run_fold_matches_jax(jax_fold):
    res = run_port_fold(jax_fold)
    tr = jax_fold["idx"][0]
    assert len(res.step_losses) == 3 * (len(tr) // KW["batch_size"])
    assert np.isfinite(res.step_losses).all() and res.step_ms == []
    jv = jax_fold["valid"]
    assert len(res.epoch_valid) == len(jv) == 3
    for (p_auc, _, p_loss), (j_auc, _, _, _, j_loss) in zip(res.epoch_valid, jv):
        assert abs(p_loss - j_loss) <= 1e-5
        assert p_auc == j_auc
    jr = jax_fold["res"]
    np.testing.assert_array_equal(res.y_true, jr.y_true)
    for key in ("epoch_pred", "epoch_pred_by_loss", "epoch_pred_by_epoch"):
        a, b = getattr(res, key), getattr(jr, key)
        assert sorted(a) == sorted(b) == CHECK
        for e in CHECK:
            np.testing.assert_allclose(a[e], b[e], rtol=0, atol=1e-5)
