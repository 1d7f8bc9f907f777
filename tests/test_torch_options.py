"""The MultilevelGNN options the port once refused, first half, against the
JAX package on the small windowed fold of test_torch_slice.py, from the
same flax parameters (tests/torch_zoo.py): resgnn, dense_gnn, repeat_mask
(with repeat_norm) and the head's pca_prelinear, each a case of
test_branch_matches_jax, which replaces test_torch_slice.py's
NotImplementedError cases (its gin and gat cases:
test_torch_convzoo_model.py).

f32: eval probabilities, loss and image within 1e-5 x max(1, max|ref|);
five train steps' losses and the first step's gradients within 1e-5; the
parameters after five steps within 2 * lr * steps.  The bf16 trunk
against JAX's: test_torch_options_bf16.py.
"""
import pytest

import torch_zoo as tz
from test_torch_slice import fold  # noqa: F401  (fixture)
from torch_threads import few_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize("option", ["resgnn", "dense_gnn", "repeat_mask", "pca_prelinear"])
def test_branch_matches_jax(fold, option):  # noqa: F811
    r = tz.run_option(fold, option, False)
    tz.check_eval(r, 1e-5)
    tz.check_train_f32(r)
    m = r["model"]
    if option == "dense_gnn":  # the head reads every layer's features
        assert m.conv_head.Conv_0.in_channels == 16 + 8


def test_resgnn_widths_must_agree_as_in_jax(fold):  # noqa: F811
    """x + layer(x) at 8 -> 16 channels: JAX's add does not broadcast, nor
    does the port's."""
    import jax
    import numpy as np
    import torch
    from multilevel_gnn_tpu.models.multilevel_gnn import MultilevelGNN as JModel
    from multilevel_gnn_tpu.train.driver import iter_batches as j_iter_batches
    from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
    from multilevel_gnn_tpu_torch.train.driver import iter_batches
    from test_torch_slice import B, G, P

    jcfg, pcfg = tz.configs(False, False, resgnn=True)
    jb = next(iter(j_iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B,
                                  np.random.RandomState(0), False, False)))
    with pytest.raises(TypeError):
        JModel(jcfg).init(jax.random.PRNGKey(0), jb, fold["jctx"], False)
    pb = next(iter(iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B, "cpu")))
    with pytest.raises(RuntimeError), torch.no_grad():
        MultilevelGNN(pcfg, fold["n"], G, device="cpu").eval()(pb, fold["pctx"])
