"""The VAE (also 'mmd_vae'), VQ-VAE and VAE classifier ('vae_finetune') in
the port against the JAX package, on the CPU, f32, from the same flax
parameters (torch_families.small_fold):

- VAE, flatten decoder with the rbf MMD kernel and foreach with imq, with
  JAX's Gaussian draws handed to the port (z's eps, each slot's prior):
  mu, sigma, z, the reconstruction, the std / corr aux losses, vae_loss's
  terms and the pretraining loss's first-step gradients (std and corr
  losses on), within 1e-5 x max(1, max|ref|);
- VQ-VAE: the code indices (nearest codebook rows of each package's own
  latents) equal, the VQ loss, the reconstruction and the
  first-step gradients of vqvae_loss within 1e-5 x max(1, max|ref|); the
  quantizer alone on N(0, 1) latents, whose codes spread over the
  codebook, likewise;
- VAEClassifier with the ConvHead (the one-column image, which flax pools
  to nothing at pca_pool_dim 2), channel_one, and the DiffPool head: the
  port's eval probabilities, image and link + entropy losses against
  JAX's (training mode with dropout off), the training-mode VJP's
  gradients (R6: head_0's weight at twice its reading) and, with DiffPool,
  the training loss, within 1e-5 x max(1, max|ref|);
- embedding_reorder equals JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.models import vae as jvae
from multilevel_gnn_tpu.models.vq_vae import VQVAE as JVQ
from multilevel_gnn_tpu.models.vq_vae import vqvae_loss as jvq_loss
from multilevel_gnn_tpu.train import step as jstep
from multilevel_gnn_tpu_torch.models import vae as pvae
from multilevel_gnn_tpu_torch.train import pretrain
from multilevel_gnn_tpu_torch.train import step as pstep
from torch_families import (
    batches, check_grads, init_pair, no_dropout, pallas, port_cfg, rel_err, small_fold,
    vjp_pair)
from torch_threads import few_threads  # noqa: F401  (autouse)

VAE_CASES = {
    "flatten_rbf": dict(decoder_type="flatten", mmd_kernel_type="rbf"),
    "foreach_imq": dict(decoder_type="foreach", mmd_kernel_type="imq"),
}
# R6 (ROADMAP section 3): the softmax heads' head_0.weight VJP gradient,
# held at twice PathCNN's largest reading (this model's read 3.9e-6)
R6 = {"head_0.weight": 3.7e-5}


def jax_draws(mu_shape):
    """JAX's draws of one pretraining step: eps for z (key 1) and each
    latent slot's prior (vae_loss's key 2, split per slot), as (S, B, H)."""
    k1, k2 = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    eps = np.asarray(jax.random.normal(k1, mu_shape))
    B, S, H = mu_shape
    keys = jax.random.split(k2, S)
    prior = np.stack([np.asarray(jax.random.normal(k, (B, H))) for k in keys])
    return k1, k2, eps, prior


@pytest.mark.parametrize("case", sorted(VAE_CASES))
def test_vae_step_matches_jax_with_its_draws(case):
    f = small_fold()
    jcfg = f["jcfg"].replace(model="vae", pretrain_std_loss=True, pretrain_corr_loss=True,
                             **VAE_CASES[case])
    jb, pb = batches("raw")
    jm = jvae.VAE(jcfg)
    params, pm = init_pair(jm, jb)
    S = jcfg.pathway_num * (1 if jcfg.decoder_type == "flatten" else 3)
    H = jcfg.final_channels * jcfg.pca_dim * (3 if jcfg.decoder_type == "flatten" else 1)
    k1, k2, eps, prior = jax_draws((8, S, H))
    target = jb.x if jcfg.decoder_type == "flatten" else jb.raw_data

    def loss_fn(p):  # JAX pretrain.py:106-118 with the keys handed in
        out = jm.apply(p, jb, f["jctx"], True, rng_key=k1)
        d = jvae.vae_loss(out["pred_x"], target, out["z"], out["mu"], out["sigma"], jcfg, k2)
        loss = (d["loss"] + jcfg.pretrain_std_coef * out["aux_losses"]["std"]
                + jcfg.pretrain_corr_coef * out["aux_losses"]["corr"])
        return loss, (out, d)

    with pallas():
        (jl, (jout, jd)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    pm.train()
    pout = pm(pb, f["pctx"], eps=torch.from_numpy(eps))
    ptarget = pb.x if jcfg.decoder_type == "flatten" else pb.raw_data
    pd = pvae.vae_loss(pout["pred_x"], ptarget, pout["z"], pout["mu"], pout["sigma"],
                       port_cfg(jcfg), prior=torch.from_numpy(prior))
    for k in ("pred_x", "mu", "sigma", "z", "embedding"):
        assert rel_err(pout[k].detach().numpy(), jout[k]) <= 1e-5, k
    for k in ("std", "corr"):
        assert rel_err(float(pout["aux_losses"][k].detach()), jout["aux_losses"][k]) <= 1e-5, k
    for k in ("loss", "Reconstruction_Loss", "MMD", "KLD"):
        assert rel_err(float(pd[k]), jd[k]) <= 1e-5, k
    pm.zero_grad(set_to_none=True)
    pl, _ = pretrain.pretrain_loss(pm, "vae", pb, f["pctx"], eps=torch.from_numpy(eps),
                                   prior=torch.from_numpy(prior))
    pl.backward()
    assert rel_err(float(pl), jl) <= 1e-5
    check_grads(pm, jg)


def test_vq_vae_matches_jax():
    f = small_fold()
    jcfg = f["jcfg"].replace(model="vq_vae")
    jb, pb = batches("raw")
    jm = JVQ(jcfg)
    params, pm = init_pair(jm, jb)

    def loss_fn(p):
        out = jm.apply(p, jb, f["jctx"], True)
        d = jvq_loss(out["pred_x"], jb.x, out["vq_loss"], jcfg)
        return d["loss"], out

    with pallas():
        (jl, jout), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        flat_z = np.asarray(jout["z"]).reshape(-1, jout["z"].shape[-1])
        cb = np.asarray(params["params"]["quantizer"]["embedding"])
        jcodes = np.asarray(jnp.argmin(
            jnp.sum(flat_z ** 2, 1, keepdims=True) + jnp.sum(cb ** 2, 1)[None]
            - 2.0 * jnp.asarray(flat_z) @ jnp.asarray(cb).T, axis=1))
    pm.train()
    with torch.no_grad():
        z, cb = pm(pb, f["pctx"])["z"].reshape(-1, flat_z.shape[1]), pm.quantizer.embedding
        pcodes = torch.argmin((z ** 2).sum(1, keepdim=True) + (cb ** 2).sum(1)[None]
                              - 2.0 * z @ cb.T, dim=1)
    np.testing.assert_array_equal(pcodes.numpy(), jcodes)
    pl, parts = pretrain.pretrain_loss(pm, "vq_vae", pb, f["pctx"])
    assert rel_err(float(parts["VQ_Loss"]), jout["vq_loss"]) <= 1e-5
    assert rel_err(float(pl), jl) <= 1e-5
    pl.backward()
    check_grads(pm, jg)


def test_vector_quantizer_matches_jax():
    """The quantizer alone on N(0, 1) latents, where the codes spread (the
    model's latents at init are small, so one code is nearest to all):
    codes equal, quantised values, loss and the gradients of the loss
    plus a seeded cotangent on the quantised values within 1e-5."""
    from multilevel_gnn_tpu.models.vq_vae import VectorQuantizer as JQ
    from multilevel_gnn_tpu_torch.models.vq_vae import VectorQuantizer

    rng = np.random.RandomState(5)
    z = rng.randn(8, 5, 12).astype(np.float32)
    cot = rng.randn(8, 5, 12).astype(np.float32)
    jq = JQ(32, 12, 0.25)
    params = jq.init(jax.random.PRNGKey(0), jnp.asarray(z))

    def f(p, x):
        q, loss = jq.apply(p, x)
        return loss + jnp.sum(q * cot), (q, loss)

    (_, (jqz, jl)), (jgp, jgz) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(z))
    pq = VectorQuantizer(32, 12, 0.25)
    with torch.no_grad():
        pq.embedding.copy_(torch.from_numpy(np.asarray(params["params"]["embedding"])))
    x = torch.from_numpy(z).requires_grad_(True)
    q, loss = pq(x)
    (loss + (q * torch.from_numpy(cot)).sum()).backward()
    codes = np.argmin(((z.reshape(-1, 1, 12) - np.asarray(params["params"]["embedding"])[None])
                       ** 2).sum(-1), axis=1)
    assert len(np.unique(codes)) > 10
    # each quantised row's nearest codebook row is JAX's code
    qs = q.detach().numpy().reshape(-1, 1, 12)
    cb = pq.embedding.detach().numpy()[None]
    np.testing.assert_array_equal(np.argmin(((qs - cb) ** 2).sum(-1), axis=1), codes)
    assert rel_err(q.detach().numpy(), jqz) <= 1e-5 and rel_err(float(loss), jl) <= 1e-5
    assert rel_err(x.grad.numpy(), jgz) <= 1e-5
    assert rel_err(pq.embedding.grad.numpy(), jgp["params"]["embedding"]) <= 1e-5


CLASSIFIER = {
    "conv_head": dict(),
    "channel_one": dict(channel_one=True, pca_pool_dim=1),
    "diff_pooling": dict(reorder_type="diff_pooling", feature_drop=True),
}
CW = np.array([1.0, 1.7], np.float32)


@pytest.mark.parametrize("case", sorted(CLASSIFIER))
def test_vae_classifier_matches_jax(case, monkeypatch):
    no_dropout(monkeypatch, jvae)
    f = small_fold()
    jcfg = f["jcfg"].replace(model="vae_finetune", pca_loss=True, **CLASSIFIER[case])
    jb, pb = batches("raw")
    jm = jvae.VAEClassifier(jcfg)
    params, pm = init_pair(jm, jb)
    (jpred, jimg, jextra), jg = vjp_pair(jm, params, jb, pm, pb)
    check_grads(pm, jg, residue=R6)
    pm.eval()
    with torch.no_grad():
        ppred, pimg, pextra = pm(pb, f["pctx"])
    assert rel_err(ppred.numpy(), jpred) <= 1e-5
    assert rel_err(pimg.numpy(), jimg) <= 1e-5
    assert rel_err(float(pextra), jextra) <= 1e-5
    assert (float(jextra) > 0) == (case == "diff_pooling")
    if case == "diff_pooling":  # the loss with the link + entropy term
        with pallas():
            jl, _ = jax.jit(jstep.make_loss_fn(jm, jcfg))(
                params, jb, f["jctx"], jnp.asarray(CW), jax.random.PRNGKey(0))
        with torch.no_grad():
            pm.train()
            pl, _ = pstep.make_loss_fn(port_cfg(jcfg))(
                pm, pb, f["pctx"], torch.from_numpy(CW), torch.Generator().manual_seed(0))
        assert rel_err(float(pl), jl) <= 1e-5


def test_embedding_reorder_matches_jax():
    rng = np.random.RandomState(3)
    embs = [rng.randn(12, 4), rng.randn(12, 2, 3)]
    np.testing.assert_array_equal(pvae.embedding_reorder(embs), jvae.embedding_reorder(embs))
