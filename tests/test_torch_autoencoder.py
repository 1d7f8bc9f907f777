"""The AutoEncoder pretraining model in the port against the JAX package, on
the CPU, from the same flax parameters (torch_families.small_fold):

- f32, each decoder (flatten, foreach, foreach_diffhidden): the port's
  reconstruction and latent in eval mode against JAX's (training mode,
  which has no dropout here), and the pretraining loss
  (reconstruction_loss, std_weight on the foreach ones, pretrain_std_loss)
  with its first-step gradients, within 1e-5 x max(1, max|ref|); the last
  sage layer's MLP bias at twice R7's reading (ROADMAP section 3: its
  gradient is a sum over the N x B rows that cancels to 0.0036);
- the encoder's two kept quirks: pca_match_mask drops the PCA rows matched
  to node slot 0, and the MI mask multiplies the PCA params with
  mutual_info_mask off;
- bf16 trunk (flatten), against JAX bf16 under jit as the existing bf16
  tests hold the sage trunk (F4): reconstruction and latent within 1e-5 x
  max(1, max|ref|), the loss within 1e-4, gradients within 1e-3 of each
  parameter's largest (every other gradient reads equal), the first trunk
  MLP bias at F3 residue 1's limit (torch_zoo.SAGE_BIAS_RESIDUE).  The
  last layer's MLP bias gradient sums 8 x 159 cotangent rows that cancel
  to 1.8e-4 of their absolute sum, and XLA on the CPU adds them in bf16,
  5.4 times the gradient away from their exact sum (R7).  So that layer's
  output cotangent is held to JAX's (taken at a zero probe added to the
  JAX layer's output through flax's intercept_methods) within 1e-3 of its
  largest, and the bias gradient to the float64 sum of JAX's cotangent
  rows at twice its reading (1.16e-3 of its largest: the port rounds its
  f32 sum to bf16 once); a zeroed gradient reads 1 there.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.models.autoencoder import AutoEncoder as JAE
from multilevel_gnn_tpu.models.autoencoder import reconstruction_loss as jrecon_loss
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu_torch.models.autoencoder import AutoEncoder, next_pow2
from multilevel_gnn_tpu_torch.train import pretrain
from torch_families import (
    batches, check_grads, grads_by_name, init_pair, pallas, port_cfg, rel_err, small_fold)
from torch_threads import few_threads  # noqa: F401  (autouse)
from torch_zoo import SAGE_BIAS_RESIDUE, grad_rel

# R7 (ROADMAP section 3): read 1.23e-5 (flatten); held at twice
F32_RESIDUE = {"gnn_1.gconv.nn.Linear_0.bias": 2.5e-5}
# R7's bf16 leaf: its layer and its bias (read 1.16e-3 of the exact sum's
# largest; held at twice)
CANCELLING = ("gnn_1", "gconv", "nn", "Linear_0")
CANCELLING_BIAS = "gnn_1.gconv.nn.Linear_0.bias"
TOL_CANCELLING_BIAS = 2.4e-3
DECODERS = {
    "flatten": dict(decoder_type="flatten", pretrain_std_loss=True),
    "foreach": dict(decoder_type="foreach", std_weight=True, std_weight_coef=2.0),
    "foreach_diffhidden": dict(decoder_type="foreach_diffhidden", std_weight=True,
                               mutual_info_mask=False),
}


def jax_ae(bf16=False, **kw):
    jcfg = small_fold()["jcfg"].replace(model="autoencoder", **kw)
    if bf16:
        jcfg = jcfg.replace(compute_dtype="bfloat16", spmm_bf16=True)
    return JAE(jcfg)


def jax_loss(jm, jb, std_w):
    """JAX pretrain.py's autoencoder loss_fn (pretrain.py:93-105)."""
    cfg, ctx = jm.cfg, small_fold()["jctx"]
    target = jb.x if cfg.decoder_type == "flatten" else jb.raw_data

    def loss_fn(params):  # with its outputs: training mode is eval mode here
        recon, h = jm.apply(params, jb, ctx, True)
        loss = jrecon_loss(recon, target, cfg,
                           std_w if cfg.std_weight and cfg.decoder_type != "flatten" else None)
        if cfg.pretrain_std_loss:
            std = jnp.std(h.reshape(h.shape[0], -1), axis=0, ddof=1)
            loss = loss - cfg.pretrain_std_coef * jnp.log(std.mean())
        return loss, (recon, h)

    return loss_fn


def add_probe(probe):
    """A flax interceptor adding ``probe`` to the output of the CANCELLING
    layer (records the output's shape and dtype when probe is None)."""
    seen = {}

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.module.path == CANCELLING and context.method_name == "__call__":
            seen["out"] = jax.ShapeDtypeStruct(out.shape, out.dtype)
            if probe is not None:
                out = out + probe
        return out

    return intercept, seen


def run_pair(bf16=False, **kw):
    """Both packages' outputs, loss and first-step gradients, and the
    CANCELLING layer's output cotangent on each side (JAX's at a zero
    probe on that output)."""
    f = small_fold()
    jm = jax_ae(bf16, **kw)
    jb, pb = batches("raw")
    loss_fn = jax_loss(jm, jb, jnp.asarray(f["std_w"]))

    def probed(params, probe):
        with fnn.intercept_methods(add_probe(probe)[0]):
            return loss_fn(params)

    jspmm.set_spmm_dtype(jnp.bfloat16 if bf16 else None)
    try:
        params, pm = init_pair(jm, jb)
        with pallas():
            intercept, seen = add_probe(None)
            with fnn.intercept_methods(intercept):
                jax.eval_shape(loss_fn, params)
            probe = jnp.zeros(seen["out"].shape, seen["out"].dtype)
            (jl, (jrec, jlat)), (jg, jcot) = jax.jit(jax.value_and_grad(
                probed, argnums=(0, 1), has_aux=True))(params, probe)
    finally:
        jspmm.set_spmm_dtype(None)
    pm.eval()
    with torch.no_grad():
        prec, plat = pm(pb, f["pctx"])
    pm.train()
    cot = {}

    def keep_cotangent(mod, inp, out):
        out.register_hook(lambda g: cot.setdefault("g", g.detach()))

    hook = pm.get_submodule(".".join(CANCELLING)).register_forward_hook(keep_cotangent)
    pl, _ = pretrain.pretrain_loss(pm, "autoencoder", pb, f["pctx"],
                                   torch.from_numpy(f["std_w"]))
    pl.backward()
    hook.remove()
    return dict(jrec=jrec, jlat=jlat, jl=float(jl), jg=jg, prec=prec.numpy(),
                plat=plat.numpy(), pl=float(pl.detach()), pm=pm,
                jcot=np.asarray(jcot.astype(jnp.float32), np.float64),
                pcot=cot["g"].float().transpose(0, 1).numpy().astype(np.float64))


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_autoencoder_matches_jax_f32(decoder):
    r = run_pair(**DECODERS[decoder])
    f = small_fold()
    n_out = 3 * f["jcfg"].node_num if decoder == "flatten" else f["pctx"].num_pca_rows
    assert r["prec"].shape == (8, n_out)
    assert rel_err(r["prec"], r["jrec"]) <= 1e-5
    assert rel_err(r["plat"], r["jlat"]) <= 1e-5
    assert abs(r["pl"] - r["jl"]) <= 1e-5 * max(1.0, abs(r["jl"]))
    check_grads(r["pm"], r["jg"], residue=F32_RESIDUE)


def test_foreach_decoders_by_slot():
    """One MLP per non-empty slot, named by its slot index; the
    diffhidden widths next_pow2(sqrt(genes * final_channels))."""
    cfg = port_cfg(small_fold()["jcfg"].replace(decoder_type="foreach_diffhidden",
                                                model="autoencoder"))
    sizes = cfg.slot_sizes
    m = AutoEncoder(cfg, small_fold()["pctx"].graph.n_nodes,
                    small_fold()["pctx"].num_pca_rows, device="cpu")
    assert m.dec_slots == [s for s, n in enumerate(sizes) if n > 0]
    for s in m.dec_slots:
        hidden = next_pow2(int(np.sqrt(sizes[s] * cfg.final_channels)))
        assert tuple(getattr(m, f"dec_slot{s}_0").weight.shape) == (hidden, 4 * cfg.pca_dim)
        assert tuple(getattr(m, f"dec_slot{s}_1").weight.shape) == (sizes[s], hidden)


def test_encoder_quirks():
    """pca_match_mask keeps match > 0 (slot 0's rows dropped) and the MI
    mask multiplies the PCA params with mutual_info_mask off."""
    f = small_fold()
    match = f["pctx"].gene_pca_match
    assert bool((match == 0).any())  # a PCA row on node slot 0
    cfg = port_cfg(f["jcfg"].replace(model="autoencoder", mutual_info_mask=False))
    m = AutoEncoder(cfg, f["pctx"].graph.n_nodes, f["pctx"].num_pca_rows, device="cpu")
    h = torch.ones(f["pctx"].graph.n_nodes, 2, 3)
    xg = m.gather_pca_rows(h, f["pctx"], drop_slot0=True)
    np.testing.assert_array_equal(xg[:, 0, 0].numpy(), (match > 0).float().numpy())
    _, pb = batches("raw")
    with torch.no_grad():
        m.eval()
        lat = m.encode_latent(pb, f["pctx"])
        masked = m.learnable_pca_params.clone()
        m.learnable_pca_params.mul_(f["pctx"].info_mask)
        np.testing.assert_array_equal(m.encode_latent(pb, f["pctx"]).numpy(), lat.numpy())
        m.learnable_pca_params.copy_(masked)
    assert float(f["pctx"].info_mask.min()) == 0.0  # the mask does mask


def test_autoencoder_matches_jax_bf16():
    r = run_pair(bf16=True, **DECODERS["flatten"])
    assert np.isfinite(r["prec"]).all()
    assert rel_err(r["prec"], r["jrec"]) <= 1e-5
    assert rel_err(r["plat"], r["jlat"]) <= 1e-5
    assert abs(r["pl"] - r["jl"]) <= 1e-4
    pg = {n: p.grad.numpy() for n, p in r["pm"].named_parameters()}
    rels = grad_rel(pg, grads_by_name(r["jg"]))
    for n, rel in rels.items():
        if n != CANCELLING_BIAS:
            assert rel <= SAGE_BIAS_RESIDUE.get(n, 1e-3), (n, rel)
    # R7's leaf: the port's cotangent is JAX's, and its bias gradient is
    # the exact sum of JAX's cotangent rows, rounded once
    assert r["pcot"].shape == r["jcot"].shape
    readings = cancelling_readings(r)
    assert readings["cotangent"] <= 1e-3, readings
    assert readings["port_bias"] <= TOL_CANCELLING_BIAS, readings


def cancelling_readings(r) -> dict:
    """R7's bf16 leaf: the port's cotangent against JAX's over JAX's
    largest; the port's and JAX's bias gradients against the float64 sum of
    JAX's cotangent rows, over that sum's largest; and that largest over
    the largest absolute sum of the rows."""
    rows = r["jcot"].reshape(-1, r["jcot"].shape[-1])
    exact = rows.sum(0)
    big = np.abs(exact).max()
    port = r["pm"].get_parameter(CANCELLING_BIAS).grad.numpy()
    return {"cotangent": float(np.abs(r["pcot"] - r["jcot"]).max() / np.abs(rows).max()),
            "port_bias": float(np.abs(port - exact).max() / big),
            "jax_bias": float(np.abs(grads_by_name(r["jg"])[CANCELLING_BIAS] - exact).max()
                              / big),
            "sum_over_abs_sum": float(big / np.abs(rows).sum(0).max())}
