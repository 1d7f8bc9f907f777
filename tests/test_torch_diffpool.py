"""DiffPool in the port against the JAX package (f32, CPU), from the same
flax parameters:

- DenseSAGEConv, dense_diff_pool (a shared 2-D and a batched 3-D
  adjacency) and the DiffPool stack at one and two levels (coarse factor
  0.1 / 0.25): outputs, link and entropy losses, and the gradients of
  their sum plus a seeded cotangent on the pooled features, within 1e-5 x
  max(1, max|ref|);
- after_pooling_layer 2 adds BatchNorm1d: equal in eval mode, and training
  raises in both packages;
- the fold's pathway_adj equals JAX's (the pathways' PCA correlation + I);
- vae_finetune with reorder_type diff_pooling, run_experiment, 1 run x 5
  folds x 2 epochs on reference-format files (the model's fixed 0.5 head
  dropout off on both sides): every fold's test scores within 1e-5, pooled
  AUC / ACC equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.models import diffpool as jdp
from multilevel_gnn_tpu.models import vae as jvae
from multilevel_gnn_tpu_torch.interop import load_flax_params
from multilevel_gnn_tpu_torch.models import diffpool as pdp
from multilevel_gnn_tpu_torch.train import driver
from test_torch_experiment import build_setup
from torch_families import (
    check_grads, experiments_match, flat, no_dropout, port_cfg, rel_err, small_fold)
from torch_threads import few_threads  # noqa: F401  (autouse)

N, C = 12, 6


def inputs(seed=0, batched_adj=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, N, C).astype(np.float32)
    adj = (rng.rand(*((4, N, N) if batched_adj else (N, N))) > 0.6).astype(np.float32)
    return x, adj, rng.randn(4, N, 3).astype(np.float32)


def test_dense_sage_conv_matches_jax():
    x, adj, _ = inputs()
    jc = jdp.DenseSAGEConv(5)
    params = jc.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(adj))
    pc = pdp.DenseSAGEConv(C, 5)
    load_flax_params(pc, flat(params))
    out = pc(torch.from_numpy(x), torch.from_numpy(adj))
    assert rel_err(out.detach().numpy(), jc.apply(params, jnp.asarray(x), jnp.asarray(adj))) <= 1e-5
    assert float(pc.lin_rel.bias.abs().max()) == 0.0  # nn.Dense's zero bias


@pytest.mark.parametrize("batched_adj", [False, True], ids=["adj2d", "adj3d"])
def test_dense_diff_pool_matches_jax(batched_adj):
    x, adj, s = inputs(1, batched_adj)
    jout = jdp.dense_diff_pool(jnp.asarray(x), jnp.asarray(adj), jnp.asarray(s))
    pout = pdp.dense_diff_pool(torch.from_numpy(x), torch.from_numpy(adj), torch.from_numpy(s))
    for a, b in zip(pout, jout):
        assert rel_err(np.asarray(a), b) <= 1e-5


def stack_pair(levels, after=1, seed=0):
    cfg = small_fold()["jcfg"].replace(after_pooling_layer=after)
    jm = jdp.DiffPool(cfg, C, N, levels, 6, 5)
    x, adj, _ = inputs(seed)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(adj))
    pm = pdp.DiffPool(port_cfg(cfg), C, N, levels, 6, 5)
    load_flax_params(pm, flat(params))
    return jm, params, pm, x, adj


@pytest.mark.parametrize("levels", [1, 2])
def test_diffpool_stack_matches_jax(levels):
    jm, params, pm, x, adj = stack_pair(levels)
    n_out = {1: 2, 2: 1}[levels]  # ceil(0.1 * 12); ceil(ceil(0.25 * 12) * 0.25)
    cot = np.random.RandomState(7).randn(4, n_out, 5).astype(np.float32)

    def f(p):
        out, l, e = jm.apply(p, jnp.asarray(x), jnp.asarray(adj))
        return l + e + jnp.sum(out * cot), (out, l, e)

    (_, (jout, jl, je)), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    out, l, e = pm(torch.from_numpy(x), torch.from_numpy(adj))
    assert out.shape == (4, n_out, 5) and pm.out_width == n_out * 5
    assert rel_err(out.detach().numpy(), jout) <= 1e-5
    assert rel_err(float(l), jl) <= 1e-5 and rel_err(float(e), je) <= 1e-5
    (l + e + (out * torch.from_numpy(cot)).sum()).backward()
    check_grads(pm, jg)


def test_batchnorm_after_pooling():
    """after_pooling_layer 2: BatchNorm1d between the convs, equal in eval
    mode; training raises in both packages (no batch_stats in JAX's step)."""
    jm, params, pm, x, adj = stack_pair(2, after=2)
    assert "batch_stats" in params
    pm.eval()
    with torch.no_grad():
        out, _, _ = pm(torch.from_numpy(x), torch.from_numpy(adj))
    jout, _, _ = jm.apply(params, jnp.asarray(x), jnp.asarray(adj))
    assert rel_err(out.numpy(), jout) <= 1e-5
    pm.train()
    with pytest.raises(RuntimeError, match="batch_stats"):
        pm(torch.from_numpy(x), torch.from_numpy(adj))
    with pytest.raises(Exception):  # flax: batch_stats is immutable in apply
        jm.apply(params, jnp.asarray(x), jnp.asarray(adj), training=True)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return build_setup(str(tmp_path_factory.mktemp("cohort")))


def test_fold_pathway_adj_matches_jax(setup):
    jc, pc = setup["jcohort"], setup["cohort"]
    tr = driver.fold_indices(pc.labels(), setup["cfg"], 3)[0]
    jfold = jc.fold(tr, 3)
    pfold = pc.fold(tr, 3, device="cpu")
    adj = pfold.ctx.pathway_adj.numpy()
    np.testing.assert_array_equal(adj, np.asarray(jfold.ctx.pathway_adj))
    np.testing.assert_array_equal(np.diag(adj), np.diag(adj).round())  # corr 1 or NaN->0, + I
    assert adj.shape == (pc.n_pathways, pc.n_pathways)


def test_vae_finetune_diffpool_protocol_matches_jax(setup, monkeypatch):
    no_dropout(monkeypatch, jvae)
    kw = dict(model="vae_finetune", reorder_type="diff_pooling", epochs=2,
              diff_pooling_hidden_dim=6, diff_pooling_output_dim=5)
    experiments_match(setup["jcohort"], setup["cohort"], setup["cfg"].replace(**kw),
                      monkeypatch, jcfg=setup["jcohort"].cfg.replace(**kw))
