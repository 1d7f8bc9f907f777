"""Shared runs for the conv-zoo and model-option parity tests: one config
through the JAX MultilevelGNN (the 'pallas' backend, Pallas in interpret
mode, jitted as its train and eval steps are) and through the PyTorch port
from the same flax parameters, on the small fold of test_torch_slice.py.

run_pair(fold, bf16, **cfg) returns, for both sides:
  eval   probabilities and eval_step loss over the three batches, and the
         first batch's pathway image (eval mode);
  grads  the first training step's gradients by the port's parameter names
         (dropout off, class weights, feature losses on; JAX's from its
         train_step's computation under jax.jit);
  train  five train steps' losses, and the port's parameters after them
         against JAX's.

pca_lowrank's start block is the one draw the two packages cannot share:
the port's ops.pca.start_block is handed JAX's normal(PRNGKey(0)) draw.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.models.multilevel_gnn import MultilevelGNN as JModel
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu.train import step as jstep
from multilevel_gnn_tpu.train.driver import iter_batches as j_iter_batches
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.interop import load_flax_params, state_dict_from_flax
from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
from multilevel_gnn_tpu_torch.ops import pca as ppca
from multilevel_gnn_tpu_torch.train import step as pstep
from multilevel_gnn_tpu_torch.train.driver import iter_batches

from test_torch_slice import B, G, N_PATHWAYS, P, _cfg_dict

LR = 1e-3
STEPS = 5
CW = np.array([1.0, 1.7], np.float32)
TRAIN_KW = dict(feature_drop=False, head_drop_rate=0.0, gnn_dropout=0.0, lr=LR,
                weight_balance=True, pca_indep_loss=True, pca_loss=True)
BF16_KW = dict(compute_dtype="bfloat16", spmm_bf16=True)


def slot_sizes(fold):
    """Genes per pathway-omics slot of the fold (Cohort.slot_sizes)."""
    return tuple(int(c) for c in np.bincount(fold["pctx"].raw_indice.numpy(),
                                             minlength=3 * N_PATHWAYS))


def jax_start_block(shape, dtype, device):
    """JAX's pca_lowrank start block, normal(PRNGKey(0)) (ops/pca.py:37)."""
    q = jax.random.normal(jax.random.PRNGKey(0), tuple(shape), jnp.float32)
    return torch.from_numpy(np.asarray(q)).to(device, dtype)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def configs(bf16, train, **kw):
    d = dict(kw)
    if train:
        d = {**TRAIN_KW, **d}
    if bf16:
        d.update(BF16_KW)
    return JConfig.from_dict(_cfg_dict(**d)), Config.from_dict(_cfg_dict(**d))


def run_pair(fold, bf16, train=True, steps=STEPS, **kw):
    """Eval, first-step gradients and `steps` train steps of one config on
    both sides (train=False: eval only, from the eval config)."""
    jcfg, pcfg = configs(bf16, train, **kw)
    jctx, pctx = fold["jctx"], fold["pctx"]
    jb = list(j_iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B,
                             np.random.RandomState(0), False, False))
    pb = list(iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B, "cpu"))
    jmodel = JModel(jcfg)
    out = {}
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    jspmm.set_spmm_dtype(jnp.bfloat16 if bf16 else None)
    try:
        params = jax.jit(lambda k: jmodel.init(k, jb[0], jctx, False))(jax.random.PRNGKey(0))
        # strong types, as after a first update: a fresh prelu slope is a
        # weak f32 (ROADMAP section 3, R3)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)), params)
        flat0 = _flat(params)
        eval_cfg = jcfg.replace(weight_balance=False, weighted_loss=False,
                                batch_weighted_loss=False)

        @jax.jit
        def ev(params, batch, ctx):  # the package's eval_step, and the image
            pred, image = jmodel.apply(params, batch, ctx, False)
            loss = jstep.classification_loss(pred, batch.y, None, batch.sample_mask,
                                             eval_cfg)
            return pred, loss, image

        ev_out = [ev(params, b, jctx) for b in jb]
        out["jp"] = np.stack([np.asarray(p) for p, _, _ in ev_out]).astype(np.float64)
        out["jl"] = np.array([float(l) for _, l, _ in ev_out])
        out["jimg"] = np.asarray(ev_out[0][2], np.float64)
        if train:
            # the package's train_step (train/step.py:218-225), returning the
            # gradients too, so one compile gives the first step's and the
            # five steps
            loss_fn = jstep.make_loss_fn(jmodel, jcfg)
            tx = jstep.make_optimizer(jcfg, 3)

            @jax.jit
            def step(params, opt_state, batch, ctx, cw, rng):
                (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                    params, batch, ctx, cw, rng)
                updates, opt_state = tx.update(grads, opt_state, params)
                return optax.apply_updates(params, updates), opt_state, loss, grads

            opt_state = tx.init(params)
            losses = []
            for i in range(steps):
                params, opt_state, loss, grads = step(
                    params, opt_state, jb[i % len(jb)], jctx, jnp.asarray(CW),
                    jax.random.PRNGKey(i))
                losses.append(float(loss))
                if i == 0:
                    out["jgrad"] = {k: v.numpy().astype(np.float64) for k, v in
                                    state_dict_from_flax(_flat(grads)).items()}
            out["jtrain"] = np.array(losses)
            flat1 = _flat(params)
    finally:
        jspmm.set_backend(prev)
        jspmm.set_spmm_dtype(None)

    model = MultilevelGNN(pcfg, fold["n"], G, device="cpu")
    load_flax_params(model, flat0)
    with torch.no_grad():
        model.eval()
        pev = [pstep.eval_step(model, b, pctx) for b in pb]
        out["pimg"] = model(pb[0], pctx)[1].numpy().astype(np.float64)
    out["pp"] = np.stack([p.numpy() for p, _ in pev]).astype(np.float64)
    out["pl"] = np.array([float(l) for _, l in pev])
    out["model"] = model
    if train:
        model.train()
        loss, _ = pstep.make_loss_fn(pcfg)(model, pb[0], pctx, torch.from_numpy(CW),
                                           torch.Generator().manual_seed(0))
        loss.backward()
        out["pgrad"] = {n: p.grad.numpy().astype(np.float64)
                        for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        opt = pstep.make_optimizer(model, pcfg, 3)
        gen = torch.Generator().manual_seed(0)
        out["ptrain"] = np.array([
            float(pstep.train_step(model, opt, pb[i % len(pb)], pctx, torch.from_numpy(CW), gen))
            for i in range(steps)])
        ref = MultilevelGNN(pcfg, fold["n"], G, device="cpu")
        load_flax_params(ref, flat1)
        out["ref_after"] = {n: p.detach().numpy().astype(np.float64)
                            for n, p in ref.named_parameters()}
        out["port_after"] = {n: p.detach().numpy().astype(np.float64)
                             for n, p in model.named_parameters()}
        out["start"] = {n: v.numpy().astype(np.float64)
                        for n, v in state_dict_from_flax(flat0).items()}
    return out


def rel_err(a, ref):
    """max|a - ref| / max(1, max|ref|)."""
    return float(np.abs(a - ref).max() / max(1.0, float(np.abs(ref).max())))


def grad_rel(pg, jg):
    """max|diff| / max|grad| per parameter."""
    assert set(pg) == set(jg), (sorted(set(pg) ^ set(jg)))
    return {n: float(np.abs(pg[n] - g).max() / max(np.abs(g).max(), 1e-30))
            for n, g in jg.items()}


def check_eval(r, tol):
    """Probabilities, loss and image within tol * max(1, max|ref|)."""
    assert np.isfinite(r["pp"]).all() and np.isfinite(r["pimg"]).all()
    assert rel_err(r["pp"], r["jp"]) <= tol, rel_err(r["pp"], r["jp"])
    assert rel_err(r["pl"], r["jl"]) <= tol, rel_err(r["pl"], r["jl"])
    assert rel_err(r["pimg"], r["jimg"]) <= tol, rel_err(r["pimg"], r["jimg"])


def check_train_f32(r):
    """f32: losses within 1e-5 x max(1, |loss|), first-step gradients within
    1e-5 x max(1, max|grad|) per parameter, and the parameters after five
    steps within 2 * lr * steps (Adam's worst case on a gradient near zero,
    whose sign can flip: GCN moves 6 of node_embedding's 2,800 entries
    1.9e-5 apart where the first gradient is above 1e-3 of its largest);
    the run moved them."""
    assert np.isfinite(r["ptrain"]).all()
    assert rel_err(r["ptrain"], r["jtrain"]) <= 1e-5, (r["ptrain"], r["jtrain"])
    for n, g in r["jgrad"].items():
        assert rel_err(r["pgrad"][n], g) <= 1e-5, (n, rel_err(r["pgrad"][n], g))
    moved = 0.0
    for n, p in r["port_after"].items():
        diff = np.abs(p - r["ref_after"][n])
        assert diff.max() <= 2 * LR * STEPS, (n, diff.max())
        moved = max(moved, float(np.abs(p - r["start"][n]).max()))
    assert moved > LR


def check_train_bf16(r, residue=None, loss_tol=1e-4):
    """bf16 against JAX's bf16 (F4): five steps' losses within 1e-4, the
    first step's gradients within 1e-3 of each parameter's largest, the
    named residues within theirs."""
    residue = residue or {}
    assert np.isfinite(r["ptrain"]).all()
    assert np.abs(r["ptrain"] - r["jtrain"]).max() <= loss_tol, (r["ptrain"], r["jtrain"])
    for n, rel in grad_rel(r["pgrad"], r["jgrad"]).items():
        assert rel <= residue.get(n, 1e-3), (n, rel)


# Eight of the ten configs test_torch_slice.py once held to
# NotImplementedError, each now a parity case (its gin and gat cases:
# test_torch_convzoo_model.py), and the options the port added beside them.
# "auto" slot sizes come from the fold (slot_sizes); resgnn keeps every
# width at 8, so x + layer(x) adds.
FORMER = {
    "resgnn": dict(resgnn=True, hidden_channels=8),
    "dense_gnn": dict(dense_gnn=True),
    "repeat_mask": dict(repeat_mask=True, repeat_norm=True, repeat_cyclic=1),
    "pca_prelinear": dict(pca_prelinear=True),
    "multilevel_gnn_seq": dict(model="multilevel_gnn_seq", only_mrna_pred=True),
    "used_omics": dict(used_omics="01"),
    "pca_svd": dict(reduction_method="pca_svd", slot_sizes="auto"),
    "gnn_mlp_norm_batch": dict(gnn_mlp_norm="batch"),
}
EXTRA = {
    # one subspace iteration: the QR loop's gradient is the costliest compile
    "pca_lowrank": dict(reduction_method="pca_lowrank", slot_sizes="auto",
                        pca_lowrank_niter=1),
    "gnn_mlp_norm_layer": dict(gnn_mlp_norm="layer"),
    "prelu": dict(gnn_act="prelu"),
    "mr_last_norm_layer": dict(gnn_name="mr", gnn_last_norm="layer"),
}
# norm 'batch' cannot train in either package; JAX's SVD gradient is NaN on
# a padded batch (ROADMAP section 3)
EVAL_ONLY = {"gnn_mlp_norm_batch", "pca_svd"}


def option_kw(fold, name):
    kw = dict({**FORMER, **EXTRA}[name])
    if kw.get("slot_sizes") == "auto":
        kw["slot_sizes"] = slot_sizes(fold)
    return kw


def run_option(fold, name, bf16, monkeypatch=None):
    """run_pair of one option; pca_lowrank's port takes JAX's start block."""
    kw = option_kw(fold, name)
    if kw.get("reduction_method") == "pca_lowrank":
        monkeypatch.setattr(ppca, "start_block", jax_start_block)
    return run_pair(fold, bf16, train=name not in EVAL_ONLY, **kw)


# The trunk MLP biases' bf16 gradients on the sage path (F3 residue 1,
# test_torch_train.py's BF16_GRAD_RESIDUE)
SAGE_BIAS_RESIDUE = {"gnn_0.gconv.nn.Linear_0.bias": 1.4e-2,
                     "gnn_1.gconv.nn.Linear_0.bias": 8.0e-3}


HEAD_OPTIONS = {"pca_prelinear", "multilevel_gnn_seq", "used_omics"}


def check_option_bf16(r, readings, train=True):
    """The bf16 trunk against JAX's bf16 under jit (F4: probabilities, loss
    and image 1e-5; five-step losses 1e-4; first-step gradients 1e-3 of
    each parameter's largest), or twice the option's reading where it
    carries a residue of ROADMAP section 3 (R4: XLA on the CPU drops the
    bf16 rounding between elementwise ops under jit, where the port rounds
    each op as written)."""
    lim = {k: max(2 * v, 1e-5) for k, v in readings.get("eval", {}).items()}
    assert np.isfinite(r["pp"]).all() and np.isfinite(r["pimg"]).all()
    assert rel_err(r["pp"], r["jp"]) <= lim.get("prob", 1e-5), rel_err(r["pp"], r["jp"])
    assert rel_err(r["pl"], r["jl"]) <= lim.get("loss", 1e-5), rel_err(r["pl"], r["jl"])
    assert rel_err(r["pimg"], r["jimg"]) <= lim.get("image", 1e-5), rel_err(r["pimg"], r["jimg"])
    if train:
        grad = {**SAGE_BIAS_RESIDUE,
                **{k: max(2 * v, 1e-3) for k, v in readings.get("grad", {}).items()}}
        check_train_bf16(r, grad, max(2 * readings.get("steps", 0.0), 1e-4))
