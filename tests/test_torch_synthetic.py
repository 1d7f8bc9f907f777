"""The PyTorch port's synthetic GBM-scale inputs against the JAX package's.

make_cohort_topology and make_gbm_scale_setup with the same RandomState
seed give bit-identical edge arrays, edge attributes, context arrays and
batch arrays (required equal, no tolerance), at reduced node / pathway /
row counts, for both topologies, with and without the window plan, and
with gnn_name mr and edge (the arrays do not depend on the conv).
"""
import numpy as np
import pytest

from multilevel_gnn_tpu.data import synthetic as JS
from multilevel_gnn_tpu_torch.data import synthetic as S


@pytest.mark.parametrize("seed", [0, 7])
def test_cohort_topology_bit_equal(seed):
    js, jd, jn = JS.make_cohort_topology(np.random.RandomState(seed), n_genes=300)
    ps, pd, pn = S.make_cohort_topology(np.random.RandomState(seed), n_genes=300)
    assert jn == pn
    np.testing.assert_array_equal(js, ps)
    np.testing.assert_array_equal(jd, pd)


@pytest.mark.parametrize(
    "topology,windowed", [("random", False), ("cohort", True)]
)
def test_gbm_scale_setup_bit_equal(topology, windowed):
    kw = dict(node_num=150, n_pathways=6, n_edges=3000, batch=4,
              gene_rows=400, seed=3, topology=topology, windowed=windowed)
    _, _, jg, jctx, jb = JS.make_gbm_scale_setup(**kw)
    cfg, model, pg, pctx, pb = S.make_gbm_scale_setup(device="cpu", **kw)
    for a, b in (
        (jg.senders, pg.senders), (jg.receivers, pg.receivers),
        (jg.edge_attr, pg.edge_attr), (jg.edge_mask, pg.edge_mask),
        (jg.in_deg, pg.in_deg),
        (jctx.gene_pca_match, pctx.gene_pca_match),
        (jctx.raw_indice, pctx.raw_indice), (jctx.info_mask, pctx.info_mask),
        (jctx.reorder_idxs, pctx.reorder_idxs),
        (jb.x, pb.x), (jb.y, pb.y), (jb.age, pb.age),
        (jb.sample_mask, pb.sample_mask),
    ):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (jg.winplan is not None) == (pg.winplan is not None) == windowed
    if windowed:
        assert pg.winplan.n_res == int(jg.winplan.n_res)
    assert model.cfg.batch_size == 4 and cfg.pathway_num == 6


@pytest.mark.parametrize("gnn_name", ["mr", "edge"])
def test_gbm_scale_setup_gnn_name(gnn_name):
    """gnn_name picks the conv and nothing else: the arrays stay bit-equal
    to the JAX setup's, which has only sage."""
    kw = dict(node_num=150, n_pathways=6, n_edges=3000, batch=4,
              gene_rows=400, seed=3, topology="cohort")
    _, _, jg, jctx, jb = JS.make_gbm_scale_setup(**kw)
    cfg, model, pg, pctx, pb = S.make_gbm_scale_setup(device="cpu", gnn_name=gnn_name, **kw)
    for a, b in ((jg.senders, pg.senders), (jg.receivers, pg.receivers),
                 (jg.edge_attr, pg.edge_attr), (jctx.gene_pca_match, pctx.gene_pca_match),
                 (jb.x, pb.x), (jb.y, pb.y)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert cfg.gnn_name == gnn_name
    assert type(model.gnn_0.gconv).__name__ == {"mr": "MRConv", "edge": "EdgeConv"}[gnn_name]
