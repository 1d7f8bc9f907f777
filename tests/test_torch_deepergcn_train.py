"""DeeperGCN training in the PyTorch port against the JAX package's, on the
small gene-level fold of test_torch_deepergcn_model.py, from the same flax
parameters, dropout off (masks cannot match across frameworks):

- five train steps (gbm.yaml's Adam and weight-balanced loss, lr 1e-3):
  losses in f32 within 1e-5 (max and softmax with a learned t), the bf16
  trunk against JAX's bf16 within twice the residue's reading; parameters
  after the steps as test_torch_train.py holds them;
- the first step's gradients per parameter, max|diff| / max|grad|, f32:
  1e-3 (the edge-id table's, through the deterministic K1 lookup backward,
  among them);
- train_step with DeeperGCN adds no feature loss (aux None);
- apply_init_weight: Xavier-uniform bounds on every Linear weight, zero
  biases, the attention projections and embeddings untouched, head_only
  limited to head_*.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.models.deepergcn import DeeperGCN as JModel
from multilevel_gnn_tpu.train import step as jstep
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.interop import load_flax_params, state_dict_from_flax
from multilevel_gnn_tpu_torch.models.deepergcn import DeeperGCN, apply_init_weight
from multilevel_gnn_tpu_torch.nn.basic import Linear, xavier_bound
from multilevel_gnn_tpu_torch.train import step as pstep

from test_torch_deepergcn_model import B, batches, cfg_dict, flat_params, fold, pallas
from torch_threads import few_threads  # noqa: F401  (autouse)

LR, STEPS = 1e-3, 5
TRAIN = dict(dropout=0.0, feature_drop=False, pre_readout_drop=True, lr=LR,
             weight_balance=True)
# five bf16 steps' losses against JAX's jitted bf16, max|diff| / max(1,
# |loss|): twice the reading of tests/torch_deepergcn_report.py (3.91e-4)
BF16_STEP_RESIDUE = 7.9e-4
CASES = {"max": dict(gcn_aggr="max"), "softmax_t": dict(gcn_aggr="softmax", learn_t=True)}


def _train(bf16=False, **kw):
    f = fold()
    kw = {**TRAIN, **kw, **(dict(compute_dtype="bfloat16") if bf16 else {})}
    jcfg, pcfg = JConfig.from_dict(cfg_dict(**kw)), Config.from_dict(cfg_dict(**kw))
    jb, pb = batches(f)
    cw = np.array([1.0, 1.7], np.float32)
    jm = JModel(jcfg)

    def run():
        fns = jstep.build_train_fns(jm, jcfg)
        params, opt_state = fns.init_state(jax.random.PRNGKey(0), jb[0], f["jctx"], 3)
        flat0 = flat_params(params)
        loss_fn = jstep.make_loss_fn(jm, jcfg)
        g0 = jax.jit(jax.grad(lambda p: loss_fn(p, jb[0], f["jctx"], jnp.asarray(cw),
                                                jax.random.PRNGKey(0))[0]))(params)
        losses = []
        for i in range(STEPS):
            params, opt_state, loss = fns.train_step(
                params, opt_state, jb[i % len(jb)], f["jctx"], jnp.asarray(cw),
                jax.random.PRNGKey(i))
            losses.append(float(loss))
        return flat0, flat_params(g0), flat_params(params), np.array(losses)

    flat0, g0, flat1, jl = pallas(run)
    model = DeeperGCN(pcfg, device="cpu")
    load_flax_params(model, flat0)
    model.train()
    loss, _ = pstep.make_loss_fn(pcfg)(model, pb[0], f["pctx"], torch.from_numpy(cw),
                                       torch.Generator().manual_seed(0))
    loss.backward()
    pgrad = {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    opt = pstep.make_optimizer(model, pcfg, 3)
    gen = torch.Generator().manual_seed(0)
    pl = np.array([float(pstep.train_step(model, opt, pb[i % len(pb)], f["pctx"],
                                          torch.from_numpy(cw), gen))
                   for i in range(STEPS)])
    ref = DeeperGCN(pcfg, device="cpu")
    load_flax_params(ref, flat1)
    return dict(jl=jl, pl=pl, model=model, ref=ref, jgrad=state_dict_from_flax(g0),
                pgrad=pgrad)


@pytest.mark.parametrize("case", list(CASES))
def test_five_train_steps_f32_match_jax(case):
    r = _train(**CASES[case])
    assert np.isfinite(r["pl"]).all()
    assert np.abs(r["pl"] - r["jl"]).max() <= 1e-5 * max(1.0, np.abs(r["jl"]).max())
    want = dict(r["ref"].named_parameters())
    for name, p in r["model"].named_parameters():
        diff = (p - want[name]).abs().detach()
        assert float(diff.max()) <= 2 * LR * STEPS, (name, float(diff.max()))
        g = r["jgrad"][name].abs()
        clear = g > 1e-3 * float(g.max())
        if bool(clear.any()):
            assert float(diff[clear].max()) <= 1e-5, (name, float(diff[clear].max()))
    # the first step's gradients, per parameter
    assert set(r["jgrad"]) == set(r["pgrad"])
    for name, g in r["jgrad"].items():
        rel = float((r["pgrad"][name] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        assert rel <= 1e-3, (name, rel)
    assert float(r["pgrad"]["edge_encoder.embedding"].abs().max()) > 0


def test_five_train_steps_bf16_within_residue_of_jax_bf16():
    r = _train(bf16=True, **CASES["max"])
    assert np.isfinite(r["pl"]).all()
    assert np.abs(r["pl"] - r["jl"]).max() <= BF16_STEP_RESIDUE * max(1.0, np.abs(r["jl"]).max())


def test_deepergcn_loss_has_no_feature_loss():
    f = fold()
    cfg = Config.from_dict(cfg_dict(**TRAIN, pca_loss=True, pca_indep_loss=True))
    model = DeeperGCN(cfg, device="cpu")
    pb = batches(f)[1][0]
    model.train()
    loss, pred = pstep.make_loss_fn(cfg)(model, pb, f["pctx"], None, None)
    assert not hasattr(model, "learnable_pca_params")
    base = pstep.classification_loss(pred, pb.y, None, pb.sample_mask, cfg)
    assert float(loss.detach()) == float(base.detach())


@pytest.mark.parametrize("head_only", [False, True])
def test_apply_init_weight_draws_xavier_and_zero_biases(head_only):
    cfg = Config.from_dict(cfg_dict(pathway_readout="MSA", num_layer_head=3))
    model = DeeperGCN(cfg, device="cpu", seed=1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    apply_init_weight(model, torch.Generator().manual_seed(2), head_only=head_only)
    seen = set()
    for name, m in model.named_modules():
        if not isinstance(m, Linear):
            continue
        in_head = any(s.startswith("head") for s in name.split("."))
        w = m.weight.detach()
        if head_only and not in_head:
            assert torch.equal(w, before[f"{name}.weight"])
            continue
        out_f, in_f = w.shape
        bound = xavier_bound(in_f, out_f)
        assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.5 * bound
        assert not torch.equal(w, before[f"{name}.weight"])
        assert float(m.bias.abs().max()) == 0.0
        seen.add(name.split(".")[0])
    assert ("head_0" in seen) and (head_only or "gcn_0" in seen)
    attn = model.readout_msa.MultiHeadDotProductAttention_0
    for part in ("query", "out"):
        assert torch.equal(getattr(attn, part).weight,
                           before[f"readout_msa.MultiHeadDotProductAttention_0.{part}.weight"])
    assert torch.equal(model.node_embedding_encoder.embedding,
                       before["node_embedding_encoder.embedding"])
    assert B == cfg.batch_size
