"""The k-NN information estimators of utils/knnie.py in the PyTorch port
against the JAX package's, on the CPU: vd (l_inf, l_2, l_1 balls),
revised_mi, kraskov_multi_mi, revised_multi_mi (l_inf and l_2), entropy and
kde_entropy, on seeded correlated samples (float64), equal to the JAX
package's values or within 1e-12 of them; the n <= k shortcut gives 0 in
both.  kraskov_mi has its own tests in test_torch_ppi.py.
"""
import math

import numpy as np
import pytest

from multilevel_gnn_tpu.utils import knnie as jk
from multilevel_gnn_tpu_torch.utils import knnie as pk

TOL = 1e-12


def close(a, b) -> bool:
    return a == b or abs(a - b) <= TOL * max(1.0, abs(b))


def samples(n=80, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 2)
    y = 0.6 * x[:, :1] + 0.4 * rng.randn(n, 1)
    z = rng.randn(n, 1) + 0.3 * y
    return x, y, z


@pytest.mark.parametrize("q", [math.inf, 2.0, 1.0])
def test_vd_equals_jax(q):
    for d in (1, 2, 5):
        assert close(pk.vd(d, q), jk.vd(d, q))


@pytest.mark.parametrize("q", [math.inf, 2.0])
def test_revised_estimators_equal_jax(q):
    x, y, z = samples()
    assert close(pk.revised_mi(x, y, 4, q), jk.revised_mi(x, y, 4, q))
    assert close(pk.revised_multi_mi(x, y, z, 4, q), jk.revised_multi_mi(x, y, z, 4, q))
    assert close(pk.entropy(x, 4, q), jk.entropy(x, 4, q))


def test_kraskov_multi_mi_and_kde_entropy_equal_jax():
    x, y, z = samples(seed=1)
    assert close(pk.kraskov_multi_mi(x, y, z, 3), jk.kraskov_multi_mi(x, y, z, 3))
    assert close(pk.kde_entropy(np.concatenate([x, y], 1)),
                 jk.kde_entropy(np.concatenate([x, y], 1)))


def test_few_samples_give_zero_as_in_jax():
    x, y, z = samples(n=4)
    assert pk.revised_mi(x, y, 5) == jk.revised_mi(x, y, 5) == 0.0
    assert pk.kraskov_multi_mi(x, y, z, 5) == jk.kraskov_multi_mi(x, y, z, 5) == 0.0
    assert pk.revised_multi_mi(x, y, z, 5) == jk.revised_multi_mi(x, y, z, 5) == 0.0
