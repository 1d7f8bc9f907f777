"""The options beside the ones the port once refused (see
test_torch_options.py), held to the JAX package the same way in f32:
the runtime PCA reduction pca_lowrank (the port takes JAX's start block,
torch_zoo.jax_start_block), the MLP's learned prelu on the sage path, and
mr with a string gnn_last_norm (its MLP's LayerNorm).
"""
import pytest

import torch_zoo as tz
from test_torch_slice import fold  # noqa: F401  (fixture)
from torch_threads import few_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize("option", ["pca_lowrank", "prelu", "mr_last_norm_layer"])
def test_option_matches_jax(fold, option, monkeypatch):  # noqa: F811
    r = tz.run_option(fold, option, False, monkeypatch)
    tz.check_eval(r, 1e-5)
    tz.check_train_f32(r)
    if option == "pca_lowrank":
        assert r["model"].learnable_pca_params is None


@pytest.mark.parametrize("method", ["pca_svd", "pca_lowrank"])
def test_runtime_pca_exports(fold, method):  # noqa: F811
    """The runtime PCA's factorisation loop traces into a torch.export
    program, whose call equals the live eval forward."""
    import numpy as np
    import torch

    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
    from multilevel_gnn_tpu_torch.train import export
    from multilevel_gnn_tpu_torch.train.driver import iter_batches
    from test_torch_slice import B, G, P, _cfg_dict

    cfg = Config.from_dict(_cfg_dict(reduction_method=method, slot_sizes=tz.slot_sizes(fold)))
    m = MultilevelGNN(cfg, fold["n"], G, device="cpu")
    pb = next(iter(iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B, "cpu")))
    with torch.no_grad():
        live = m.eval()(pb, fold["pctx"])[0]
    program = export.export_program(m, fold["pctx"], B, fold["n"])
    got = program.module()(pb.x, pb.age)
    assert float((got - live).abs().max()) <= 1e-6 * max(1.0, float(live.abs().max()))
