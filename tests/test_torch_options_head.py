"""The MultilevelGNN options the port once refused, second half (see
test_torch_options.py): the head's only_mrna_pred (model name
multilevel_gnn_seq) and used_omics, the runtime PCA reduction pca_svd, an
MLP norm 'batch' (eval only); and gnn_mlp_norm 'layer' and edge with
gnn_last_norm 'batch' (eval) beside them (pca_lowrank, prelu and mr with gnn_last_norm 'layer':
test_torch_options_extra.py).

pca_svd: both packages take the singular vectors' signs from the solver
(LAPACK here), so the image is held up to the sign of each (channel, slot,
column), and the probabilities only where every sign agrees (ROADMAP
section 3).  Its training is not compared: JAX's SVD gradient on a padded
batch (a rank-deficient slot block) is NaN, the port's is finite.
"""
import numpy as np
import pytest

import torch_zoo as tz
from multilevel_gnn_tpu_torch.models import get_model
from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
from test_torch_slice import fold  # noqa: F401  (fixture)
from torch_threads import few_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize("option", ["multilevel_gnn_seq", "used_omics", "gnn_mlp_norm_layer"])
def test_branch_matches_jax(fold, option):  # noqa: F811
    r = tz.run_option(fold, option, False)
    tz.check_eval(r, 1e-5)
    tz.check_train_f32(r)
    if option == "multilevel_gnn_seq":
        assert get_model("multilevel_gnn_seq") is MultilevelGNN


@pytest.mark.parametrize("option", ["gnn_mlp_norm_batch", "edge_last_norm_batch"])
def test_batch_norm_eval_matches_jax_and_cannot_train(fold, option):  # noqa: F811
    """norm 'batch' reads its initial statistics in eval, as JAX does, and
    cannot train in either package (ROADMAP section 3)."""
    import torch

    from multilevel_gnn_tpu_torch.train import step as pstep
    from multilevel_gnn_tpu_torch.train.driver import iter_batches
    from test_torch_slice import B, P

    kw = (dict(gnn_mlp_norm="batch") if option == "gnn_mlp_norm_batch"
          else dict(gnn_name="edge", gnn_last_norm="batch"))
    r = tz.run_pair(fold, False, train=False, **kw)
    tz.check_eval(r, 1e-5)
    m = r["model"].train()
    pb = next(iter(iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B, "cpu")))
    opt = pstep.make_optimizer(m, m.cfg, 3)
    with pytest.raises(RuntimeError):
        pstep.train_step(m, opt, pb, fold["pctx"], torch.ones(2), torch.Generator())


def _sign_aligned(pimg, jimg, cfg):
    """The port's image with each (channel, slot, column) flipped to JAX's
    sign, and the number of flips."""
    B, C, P, W = pimg.shape
    K = cfg.pca_dim
    p = pimg.reshape(B, C, P * 3, K)
    j = jimg.reshape(B, C, P * 3, K)
    s = np.sign((p * j).sum(0))
    s[s == 0] = 1
    return (p * s).reshape(pimg.shape), int((s < 0).sum())


def test_pca_svd_matches_jax_up_to_sign(fold):  # noqa: F811
    r = tz.run_option(fold, "pca_svd", False)
    assert np.isfinite(r["pp"]).all()
    img, flips = _sign_aligned(r["pimg"], r["jimg"], r["model"].cfg)
    assert tz.rel_err(img, r["jimg"]) <= 1e-5, tz.rel_err(img, r["jimg"])
    if flips == 0:
        assert tz.rel_err(r["pp"], r["jp"]) <= 1e-5
    assert r["model"].learnable_pca_params is None


@pytest.mark.parametrize("method", ["pca_svd", "pca_lowrank"])
def test_runtime_pca_refuses_bf16_as_jax_does(fold, method):  # noqa: F811
    """jnp.linalg.svd / qr raise NotImplementedError on the bf16 trunk's
    rows (under jit, as the package's steps run); so does the port."""
    import jax
    import torch
    from multilevel_gnn_tpu.models.multilevel_gnn import MultilevelGNN as JModel
    from multilevel_gnn_tpu.ops import spmm as jspmm
    from multilevel_gnn_tpu.train.driver import iter_batches as j_iter_batches
    from multilevel_gnn_tpu_torch.train.driver import iter_batches
    from test_torch_slice import B, G, P

    jcfg, pcfg = tz.configs(True, False, reduction_method=method,
                            slot_sizes=tz.slot_sizes(fold))
    jb = next(iter(j_iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B,
                                  np.random.RandomState(0), False, False)))
    model = JModel(jcfg)
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    try:
        # init alone never reaches the reduction's output, which jit drops
        params = jax.jit(lambda k: model.init(k, jb, fold["jctx"], False))(
            jax.random.PRNGKey(0))
        with pytest.raises(NotImplementedError):
            jax.jit(lambda p: model.apply(p, jb, fold["jctx"], False))(params)
    finally:
        jspmm.set_backend(prev)
    pb = next(iter(iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B, "cpu")))
    with pytest.raises(NotImplementedError), torch.no_grad():
        MultilevelGNN(pcfg, fold["n"], G, device="cpu").eval()(pb, fold["pctx"])
