"""The port's cohort path against the JAX package's, on the CPU.

A tiny cohort (60 patients, 6 pathways) is written by the port's
write_reference_format and loaded by both packages' load_cohort_from_files
under each shipped config (gbm, kirc, lgg) at small widths, then fold 1 of
its outer split is derived by both.  Equal: patients, node map, labels,
gene_pca_match, raw_indice, the MI mask, reorder_idxs (initial and the
fold's), the fold graph's edges, attrs and mask, the class weights.
Features within 1e-12, mutual information within 1e-10, PCA seeds within
1e-8 with their signs.

Both packages read the CSVs with their own default readers: the JAX
package with pandas.read_csv, the port with native.parse_csv_floats, which
gives pandas' default float converter's bits.  That converter is not
correctly rounded (it keeps 17 digits, leading zeros included) and reads
some values up to ~1e-13 relative away from Python's float(); an ulp moves
the pathway reorder (an argmax over a correlation matrix that np.corrcoef
does not make exactly symmetric), so the port reads as pandas does.
test_pandas_default_reader_is_not_exact pins both facts.

Also: the synthetic tables equal the JAX package's draw for draw, and a
clinical DataFrame pickle (pandas is here) loads as its dict form does.
"""
import pickle
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.data import loaders as jloaders
from multilevel_gnn_tpu.data import synthetic as jsynthetic
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.data import loaders, synthetic
from multilevel_gnn_tpu_torch.train.driver import stratified_kfold

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(hidden_channels=8, final_channels=4, node_embedding_dim=4, head_dim=16,
             conv_channel_list=[8, 16], batch_size=8)


def _paths(d):
    return dict(mrna_path=f"{d}/raw_mrna.csv", cnv_path=f"{d}/raw_cnv.csv",
                methylation_path=f"{d}/raw_methylation.csv",
                clinical_path=f"{d}/clinical.pkl", kegg_path=f"{d}/kegg.csv",
                pathway_list_path=f"{d}/pathways.txt", edge_path=f"{d}/grn_edges.tsv")


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ref"))
    synthetic.write_reference_format(d, seed=5, n_patients=60, n_pathways=6)
    return d


def _load_both(d, name):
    path = str(REPO / "configs" / f"{name}.yaml")
    jc = jloaders.load_cohort_from_files(cfg=JConfig.from_yaml(path, **SMALL), **_paths(d))
    pc = loaders.load_cohort_from_files(cfg=Config.from_yaml(path, **SMALL), **_paths(d))
    return jc, pc


@pytest.mark.parametrize("name", ["gbm", "kirc", "lgg"])
def test_cohort_and_fold_match_jax(written, name):
    jc, pc = _load_both(written, name)
    assert pc.patients == jc.patients and pc.pca_patients == jc.pca_patients
    assert pc.node_map == jc.node_map and pc.num_nodes == jc.num_nodes
    np.testing.assert_array_equal(pc.Y, jc.Y)
    np.testing.assert_array_equal(pc.labels(), jc.labels())
    np.testing.assert_array_equal(pc.ages, jc.ages)
    np.testing.assert_array_equal(pc.gene_pca_match, jc.gene_pca_match)
    np.testing.assert_array_equal(pc.raw_indice, jc.raw_indice)
    np.testing.assert_array_equal(pc.X, jc.X)
    if jc.initial_reorder_idxs is None:
        assert pc.initial_reorder_idxs is None
    else:
        np.testing.assert_array_equal(pc.initial_reorder_idxs, jc.initial_reorder_idxs)

    labels = pc.labels()
    tune, _ = stratified_kfold(labels, 5, pc.cfg.split_shaffle, pc.cfg.split_seed)[1]
    tr = tune[stratified_kfold(labels[tune], 5, pc.cfg.split_shaffle, pc.cfg.split_seed)[0][0]]
    jf, pf = jc.fold(tr, 1), pc.fold(tr, 1, device="cpu")
    np.testing.assert_array_equal(pf.info_mask, jf.info_mask)
    assert 0 < pf.info_mask.sum() < len(pf.info_mask)
    np.testing.assert_allclose(pf.mutual_info, jf.mutual_info, rtol=0, atol=1e-10)
    np.testing.assert_allclose(pf.pca_seed, jf.pca_seed, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(np.sign(pf.pca_seed), np.sign(jf.pca_seed))
    assert np.abs(pf.pca_seed).max() > 0
    np.testing.assert_array_equal(pf.reorder_idxs, jf.reorder_idxs)
    np.testing.assert_array_equal(pf.class_weight, jf.class_weight)
    np.testing.assert_allclose(pf.pathway_node_attr, jf.pathway_node_attr, rtol=0, atol=1e-12)
    assert pf.edge_count == jf.edge_count
    jg, pg = jf.ctx.graph, pf.ctx.graph
    assert pg.n_nodes == jg.n_nodes and pg.winplan is None and jg.winplan is None
    np.testing.assert_array_equal(pg.senders.numpy(), np.asarray(jg.senders))
    np.testing.assert_array_equal(pg.receivers.numpy(), np.asarray(jg.receivers))
    np.testing.assert_array_equal(pg.edge_attr.numpy(), np.asarray(jg.edge_attr))
    np.testing.assert_array_equal(pg.edge_mask.numpy(), np.asarray(jg.edge_mask))
    assert pg.num_padded_edges % 2048 == 0
    np.testing.assert_array_equal(pf.ctx.gene_pca_match.numpy(), np.asarray(jf.ctx.gene_pca_match))
    np.testing.assert_array_equal(pf.ctx.reorder_idxs.numpy(), np.asarray(jf.ctx.reorder_idxs))
    assert set(pf.seconds) == {"mi", "pca", "edges", "graph"}


def test_pandas_default_reader_is_not_exact(written):
    """pandas' default reader moves some written values by up to ~1e-13
    relative; the port's reader gives pandas' bits."""
    port = loaders.read_omics_csv(f"{written}/raw_mrna.csv")
    omics = synthetic.make_synthetic_tables(seed=5, n_patients=60, n_pathways=6)[0]
    pdf = pd.read_csv(f"{written}/raw_mrna.csv", index_col=0)
    assert list(pdf.index) == port.index and list(pdf.columns) == port.columns
    np.testing.assert_array_equal(port.values, pdf.to_numpy())
    written_values = omics["mrna"].values  # repr floats: exact round trip
    rel = np.abs(port.values - written_values) / np.abs(written_values)
    assert 0 < rel.max() <= 1e-12


def test_synthetic_tables_match_jax():
    omics, clin, kegg, pathways, edges, attrs = synthetic.make_synthetic_tables(
        seed=3, n_patients=30, n_pathways=4, n_edges=120)
    jo, jclin, jkegg, jp, je, ja = jsynthetic.make_synthetic_tables(
        seed=3, n_patients=30, n_pathways=4, n_edges=120)
    for k in omics:
        np.testing.assert_array_equal(omics[k].values, jo[k].to_numpy())
        assert omics[k].index == list(jo[k].index) and omics[k].columns == list(jo[k].columns)
    for k in ("survive_time", "survive_state", "age"):
        assert clin[k] == jclin[k].to_dict()
    assert kegg.pathway == list(jkegg.PathwayID) and kegg.symbol == list(jkegg.Symbol)
    np.testing.assert_array_equal(kegg.entrez, jkegg.Entrezid.to_numpy())
    assert pathways == jp and edges == je and attrs == ja


def test_clinical_dataframe_pickle_loads_like_the_dict(written, tmp_path):
    clin = loaders.load_clinical(f"{written}/clinical.pkl")
    df = pd.DataFrame({k: pd.Series(v) for k, v in clin.items()})
    with open(tmp_path / "clin_df.pkl", "wb") as f:
        pickle.dump(df, f)
    again = loaders.load_clinical(str(tmp_path / "clin_df.pkl"))
    for k in clin:
        assert {p: float(v) for p, v in again[k].items()} == {
            p: float(v) for p, v in clin[k].items()}
