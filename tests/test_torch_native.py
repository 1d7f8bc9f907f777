"""The port's sklearn-free and pandas-free pieces against sklearn, pandas and
PyYAML in this sandbox (the GPU hosts have none of them).

- mi_classif / mi_regression against mutual_info_classif /
  mutual_info_regression within 1e-12, with tied and rounded features,
  small classes (sklearn's brute kneighbors regime) and k = 3, 7, 15.
- pca_full against PCA(svd_solver="full"): components (signs included) and
  the transform within 1e-12, both memory layouts.
- stratified_kfold against StratifiedKFold: equal index arrays, shuffle on
  and off, several seeds, imbalanced and three-class labels.
- Frame's mean / std / quantile / clip / reindex / drop_na_line against
  pandas, bit for bit where pandas sums a column (mean, std).
- read_flat_yaml against yaml.safe_load on the shipped configs.
- parse_edge_tsv against the JAX package's C++ parser.
"""
import glob
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import yaml
from sklearn.decomposition import PCA
from sklearn.feature_selection import mutual_info_classif, mutual_info_regression
from sklearn.model_selection import StratifiedKFold

from multilevel_gnn_tpu.data import loaders as jloaders
from multilevel_gnn_tpu.data import native as jnative
from multilevel_gnn_tpu_torch.core.config import read_flat_yaml
from multilevel_gnn_tpu_torch.data import native
from multilevel_gnn_tpu_torch.data.cohort import pca_full
from multilevel_gnn_tpu_torch.data.frame import Frame, drop_na_line
from multilevel_gnn_tpu_torch.train.driver import stratified_kfold

CONFIGS = sorted(glob.glob(str(Path(__file__).resolve().parents[1] / "configs" / "*.yaml")))


def _features(seed, n, g):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, g).astype(np.float32)
    q = n // 4
    x[:q, 0] = x[q : 2 * q, 0]  # exact ties
    x[:, 1] = np.round(x[:, 1])            # few distinct values
    x[:, 2] = 3.0                          # constant
    return x


@pytest.mark.parametrize("n,g,k,p1", [(40, 30, 3, 0.3), (60, 30, 7, 0.15),
                                      (30, 20, 15, 0.4), (200, 40, 7, 0.5)])
def test_mi_matches_sklearn(n, g, k, p1):
    x = _features(n + k, n, g)
    y = (np.random.RandomState(k).rand(n) < p1).astype(np.int64)
    got = native.mi_classif(x, y, n_neighbors=k, random_state=12345)
    want = mutual_info_classif(x, y, n_neighbors=k, random_state=12345)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    got = native.mi_regression(x, y, n_neighbors=k, random_state=7)
    want = mutual_info_regression(x, y, n_neighbors=k, random_state=7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("n,f,k", [(60, 12, 3), (40, 2, 2), (25, 40, 1)])
def test_pca_matches_sklearn(n, f, k, order):
    rng = np.random.RandomState(n + f)
    data = np.asarray(rng.randn(n, f) * rng.rand(f) * 5 + rng.rand(f), order=order)
    comp, out = pca_full(data, k)
    pca = PCA(n_components=k, svd_solver="full").fit(data)
    np.testing.assert_allclose(comp, pca.components_, rtol=0, atol=1e-12)
    np.testing.assert_allclose(out, pca.transform(data), rtol=0, atol=1e-12)
    # the sign convention: each component's largest entry is positive
    big = comp[np.arange(k), np.abs(comp).argmax(axis=1)]
    assert (big > 0).all()


@pytest.mark.parametrize("seed", [1, 2, 12345])
@pytest.mark.parametrize("shuffle", [True, False])
def test_stratified_kfold_matches_sklearn(seed, shuffle):
    rng = np.random.RandomState(seed)
    for y in (rng.rand(53) < 0.2, rng.randint(0, 3, 41), np.r_[np.ones(7), np.zeros(30)]):
        got = stratified_kfold(y.astype(np.int64), 5, shuffle, seed)
        want = StratifiedKFold(5, shuffle=shuffle,
                               random_state=seed if shuffle else None).split(
            np.arange(len(y)), y)
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_frame_matches_pandas():
    rng = np.random.RandomState(0)
    a = rng.randn(300, 40) * rng.rand(40) * 7 + rng.rand(40) * 50
    a[rng.rand(300, 40) < 0.05] = np.nan
    a[:, 3] = np.nan
    rows, cols = [f"p{i}" for i in range(300)], [str(1000 + j) for j in range(40)]
    pdf, fr = pd.DataFrame(a, index=rows, columns=cols), Frame(a, rows, cols)
    np.testing.assert_array_equal(fr.mean(), pdf.mean().to_numpy())
    np.testing.assert_array_equal(fr.std(), pdf.std().to_numpy())
    np.testing.assert_allclose(fr.quantile(0.99), pdf.quantile(0.99).to_numpy(), rtol=1e-15)
    lo, hi = pdf.quantile(0.01), pdf.quantile(0.99)
    np.testing.assert_array_equal(
        fr.clip(lo.to_numpy(), hi.to_numpy()).values[:, :3],
        pdf.clip(lower=lo, upper=hi, axis=1).to_numpy()[:, :3])
    want = ["p5", "x", "p2"]
    np.testing.assert_array_equal(fr.reindex(want).values, pdf.reindex(want).to_numpy())
    np.testing.assert_array_equal(fr.select(["1003", "1001"]).values,
                                  pdf[["1003", "1001"]].to_numpy())
    b = a.copy()
    b[:5, :38] = np.nan
    got = drop_na_line(Frame(b, rows, cols))
    exp = jloaders.drop_na_line(pd.DataFrame(b, index=rows, columns=cols))
    assert got.index == list(exp.index)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: Path(p).stem)
def test_flat_yaml_matches_pyyaml(path):
    with open(path) as f:
        text = f.read()
    want, got = yaml.safe_load(text), read_flat_yaml(text)
    assert got == want
    assert all(type(got[k]) is type(want[k]) for k in want)


def test_edge_parser_matches_jax(tmp_path):
    p = tmp_path / "e.tsv"
    p.write_text("TF\ttarget\timportance\nA\tB\t0.5\nC\tD\t\nE\tF\tnan\r\nG\tH\t1e-5\n")
    assert native.parse_edge_tsv(str(p))[:2] == jnative.parse_edge_tsv(str(p))[:2]
    a, b = native.parse_edge_tsv(str(p))[2], jnative.parse_edge_tsv(str(p))[2]
    np.testing.assert_array_equal(np.array(a), np.array(b))
