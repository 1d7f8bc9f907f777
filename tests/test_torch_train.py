"""The port's loss, optimizer and train step against the JAX package's.

- BCE: at a saturated softmax (p = 0 or 1) the port's gradient is finite
  and equals JAX's _bce_bwd (atol 1e-6 relative to its size); the old
  clamped-log form gives NaN there.
- get_feature_loss: value within 1e-6 of JAX's (pca_loss and
  pca_indep_loss on); the indep term sends no gradient into the PCA params.
- Dropout: masks from the generator passed in (same seed, same masks;
  kept share 1 - rate within 0.01 on 1e5 draws; kept values scaled by
  1 / (1 - rate)); identity in eval mode; raises in training mode without
  a generator.  A training-mode forward of the small slice with gbm.yaml's
  dropouts repeats exactly from one seed.
- make_optimizer against optax (clip 20, StepLR, warmup, wd > 0) for 10
  updates on a toy tree: atol 1e-6.
- Five train steps of the small slice (the fold of test_torch_slice.py),
  dropout off, from the same flax params, composed and windowed paths:
  per-step losses atol 1e-5 (f32); params after 5 steps within
  2 * lr * steps absolute (Adam's worst case on a gradient near zero,
  whose sign can flip), and within 1e-5 where JAX's first gradient is
  above 1e-3 of its parameter's largest.  bf16 trunk: the per-step losses within
  1.5 * max|jax_bf16 - jax_f32| + 1e-3 of JAX's f32 losses.
"""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.models.multilevel_gnn import MultilevelGNN as JModel
from multilevel_gnn_tpu.models.multilevel_gnn import get_feature_loss as j_feature_loss
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu.train import step as jstep
from multilevel_gnn_tpu.train.driver import iter_batches as j_iter_batches
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.interop import load_flax_params, state_dict_from_flax
from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN, get_feature_loss
from multilevel_gnn_tpu_torch.train import step as pstep
from multilevel_gnn_tpu_torch.train.driver import iter_batches

from test_torch_slice import B, G, P, _cfg_dict, fold  # noqa: F401  (fixture)

LR = 1e-3
STEPS = 5


def test_bce_gradient_finite_at_saturation():
    p = np.array([[0.0, 1.0], [1.0, 0.0], [0.3, 0.7]], np.float32)
    t = np.array([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32)
    g = np.full_like(p, 0.5)
    _, vjp = jax.vjp(jstep.bce_elementwise, jnp.asarray(p), jnp.asarray(t))
    jd = np.asarray(vjp(jnp.asarray(g))[0], np.float64)
    pt = torch.from_numpy(p).requires_grad_(True)
    out = pstep.bce_elementwise(pt, torch.from_numpy(t))
    ref = -(t * np.maximum(np.log(np.maximum(p, 1e-45)), -100)
            + (1 - t) * np.maximum(np.log(np.maximum(1 - p, 1e-45)), -100))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6, atol=1e-6)
    out.backward(torch.from_numpy(g))
    pd = pt.grad.numpy().astype(np.float64)
    assert np.isfinite(pd).all() and np.isfinite(jd).all()
    np.testing.assert_allclose(pd, jd, rtol=1e-6, atol=0)
    # the clamped-log form the port had before: NaN on the same inputs
    q = torch.from_numpy(p).requires_grad_(True)
    old = -(torch.from_numpy(t) * torch.clamp(torch.log(q), min=-100.0)
            + (1 - torch.from_numpy(t)) * torch.clamp(torch.log(1 - q), min=-100.0))
    old.backward(torch.from_numpy(g))
    assert torch.isnan(q.grad[:2]).all()


def test_feature_loss_matches_jax(fold):
    rng = np.random.RandomState(3)
    cfg_kw = dict(_cfg_dict(), pca_loss=True, pca_loss_coef=0.7, pca_indep_loss=True)
    jcfg, pcfg = JConfig.from_dict(cfg_kw), Config.from_dict(cfg_kw)
    pca = rng.randn(G, 2).astype(np.float32)
    feat = rng.randn(B, 8, 6, 6).astype(np.float32)
    mask = np.array([True, True, True, False])
    jl = float(j_feature_loss(jnp.asarray(pca), fold["jctx"], jnp.asarray(feat),
                              jcfg, jnp.asarray(mask)))
    pt = torch.from_numpy(pca).requires_grad_(True)
    pl = get_feature_loss(pt, fold["pctx"], torch.from_numpy(feat), pcfg,
                          torch.from_numpy(mask))
    assert abs(float(pl) - jl) <= 1e-6 * max(1.0, abs(jl))
    # the indep term is detached: no gradient into the PCA params
    indep = get_feature_loss(pt, fold["pctx"], torch.from_numpy(feat),
                             pcfg.replace(pca_loss=False), None)
    assert float(indep) > 0 and not indep.requires_grad


def test_dropout_draws_from_the_given_generator(fold):
    from multilevel_gnn_tpu_torch.nn.basic import Dropout

    d = Dropout(0.25)
    x = torch.rand(100_000) + 0.5
    a = d(x, torch.Generator().manual_seed(1))
    b = d(x, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(a[kept], x[kept] / 0.75)
    assert not torch.equal(a, d(x, torch.Generator().manual_seed(2)))
    with pytest.raises(ValueError):
        d(x, None)
    d.eval()
    assert d(x, None) is x
    # the model: feature_drop 0.25 and head dropout 0.5, as gbm.yaml
    model = MultilevelGNN(Config.from_dict(_cfg_dict()), fold["n"], G, device="cpu")
    batch = next(iter(iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P),
                                   B, "cpu")))
    model.train()
    with torch.no_grad():
        p1 = model(batch, fold["pctx"], torch.Generator().manual_seed(3))[0]
        p2 = model(batch, fold["pctx"], torch.Generator().manual_seed(3))[0]
        p3 = model(batch, fold["pctx"], torch.Generator().manual_seed(4))[0]
        with pytest.raises(ValueError):
            model(batch, fold["pctx"])
    torch.testing.assert_close(p1, p2, rtol=0, atol=0)
    assert not torch.equal(p1, p3)


def test_optimizer_matches_optax():
    kw = dict(lr=1e-2, clip_grad=True, step=1, gamma=0.5, warmup_epochs=1,
              warmup_lr=1e-3, wd=0.1, beta1=0.8, beta2=0.95)
    spe = 3
    rng = np.random.RandomState(7)
    shapes = {"a": (5, 3), "b": (7,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    # norms above and below the clip at 20
    grads = [{k: (rng.randn(*s) * (12.0 if i % 2 else 1.0)).astype(np.float32)
              for k, s in shapes.items()} for i in range(10)]
    tx = jstep.make_optimizer(JConfig(**kw), spe)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = pstep.make_optimizer(module, Config(**kw), spe)
    for gr in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in gr.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in gr.items():
            getattr(module, k).grad = torch.from_numpy(v.copy())
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(getattr(module, k).detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6)
    assert opt.count == 10
    for name in ("radam", "adamw"):
        with pytest.raises(NotImplementedError):
            pstep.make_optimizer(module, Config(**kw), spe, name=name)


def _train(fold, bf16, windowed, gnn_name="sage"):
    kw = dict(feature_drop=False, head_drop_rate=0.0, gnn_dropout=0.0, lr=LR,
              weight_balance=True, pca_indep_loss=True, pca_loss=True,
              gnn_name=gnn_name)
    if bf16:
        kw.update(compute_dtype="bfloat16", spmm_bf16=True)
    jcfg = JConfig.from_dict(_cfg_dict(**kw))
    pcfg = Config.from_dict(_cfg_dict(**kw))
    jctx, pctx = fold["jctx"], fold["pctx"]
    if not windowed:
        jctx = dataclasses.replace(jctx, graph=dataclasses.replace(jctx.graph, winplan=None))
        pctx = dataclasses.replace(pctx, graph=dataclasses.replace(pctx.graph, winplan=None))
    cw = np.array([1.0, 1.7], np.float32)
    jb = list(j_iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B,
                             np.random.RandomState(0), False, False))
    pb = list(iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B, "cpu"))
    jmodel = JModel(jcfg)
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    jspmm.set_spmm_dtype(jnp.bfloat16 if bf16 else None)
    try:
        fns = jstep.build_train_fns(jmodel, jcfg)
        params, opt_state = fns.init_state(jax.random.PRNGKey(0), jb[0], jctx, 3)
        flat0 = {k: np.asarray(v) for k, v in
                 flax.traverse_util.flatten_dict(params, sep="/").items()}
        loss_fn = jstep.make_loss_fn(jmodel, jcfg)
        g0 = jax.grad(lambda p: loss_fn(p, jb[0], jctx, jnp.asarray(cw),
                                        jax.random.PRNGKey(0))[0])(params)
        grad0 = state_dict_from_flax(
            {k: np.asarray(v) for k, v in
             flax.traverse_util.flatten_dict(g0, sep="/").items()})
        jl = []
        for i in range(STEPS):
            params, opt_state, loss = fns.train_step(
                params, opt_state, jb[i % len(jb)], jctx, jnp.asarray(cw),
                jax.random.PRNGKey(i))
            jl.append(float(loss))
        flat1 = {k: np.asarray(v) for k, v in
                 flax.traverse_util.flatten_dict(params, sep="/").items()}
    finally:
        jspmm.set_backend(prev)
        jspmm.set_spmm_dtype(None)
    model = MultilevelGNN(pcfg, fold["n"], G, device="cpu")
    load_flax_params(model, flat0)
    opt = pstep.make_optimizer(model, pcfg, 3)
    gen = torch.Generator().manual_seed(0)
    pl = [float(pstep.train_step(model, opt, pb[i % len(pb)], pctx,
                                 torch.from_numpy(cw), gen)) for i in range(STEPS)]
    ref = MultilevelGNN(pcfg, fold["n"], G, device="cpu")
    load_flax_params(ref, flat1)
    return np.array(jl), np.array(pl), model, ref, flat0, grad0


@pytest.mark.parametrize("windowed", [True, False], ids=["windowed", "composed"])
def test_five_train_steps_f32_match_jax(fold, windowed):
    jl, pl, model, ref, flat0, grad0 = _train(fold, bf16=False, windowed=windowed)
    assert np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-5)
    want = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        diff = (p - want[name]).abs().detach()
        assert float(diff.max()) <= 2 * LR * STEPS, (name, float(diff.max()))
        # where JAX's first gradient is clear of zero, Adam's step has a
        # settled sign and the two runs must agree closely
        g = grad0[name].abs()
        clear = g > 1e-3 * float(g.max())
        if bool(clear.any()):
            assert float(diff[clear].max()) <= 1e-5, (name, float(diff[clear].max()))
    start = MultilevelGNN(model.cfg, fold["n"], G, device="cpu")
    load_flax_params(start, flat0)
    assert max(float((p - q).abs().max().detach()) for p, q in
               zip(model.parameters(), start.parameters())) > LR  # it trained


def test_five_train_steps_bf16_within_bound(fold):
    j32, _, _, _, _, _ = _train(fold, bf16=False, windowed=True)
    j16, p16, _, _, _, _ = _train(fold, bf16=True, windowed=True)
    assert np.isfinite(p16).all()
    assert np.abs(p16 - j32).max() <= 1.5 * np.abs(j16 - j32).max() + 1e-3
