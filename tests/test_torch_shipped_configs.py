"""kirc.yaml and lgg.yaml's main path: the port against the JAX package.

The two cohorts' shipped configs differ from gbm.yaml in the model (pca_dim
3, head_dim 512, the pathway reorder; kirc: pools 1 x 1 and no age; lgg:
the default pools 4 x 2 and the age concat) and in training (B 64, Adam at
lr 5e-5 with StepLR step 140).  Each package reads the same YAML
(Config.from_yaml / JConfig.from_yaml); the small windowed fold of
test_torch_slice.py (residual edges, a non-identity pathway reorder) then
replaces the node / pathway counts and the widths as _cfg_dict sets them,
and dropout is off on both sides.  JAX runs on the 'pallas' backend
(Pallas in interpret mode) from flax's init; the port loads those params
through interop.load_flax_params and runs its plain versions on the CPU.

- Both packages read every option of the two files alike, and the files
  say what the protocol expects (B 64, pca_dim 3, ...).
- write_reference_format writes the same bytes for every cancer type
  (chip_smoke.py links the gbm files for the kirc / lgg protocols).
- f32 trunk: the eval probabilities and loss of every batch (the last one
  padded) and five train steps' losses within 1e-5 of JAX.
- The shipped bf16 trunk (compute_dtype bfloat16, spmm_bf16) on the
  windowed route: the eval probabilities within test_torch_slice's 1e-5;
  five train steps' losses within TOL_BF16_LOSS; the first step's
  gradients, JAX under jit, within TOL_BF16_GRAD of each parameter's
  largest, apart from the trunk MLP biases (ROADMAP section 3, F3 residue
  1: XLA on the CPU sums a bf16 bias gradient in bf16, 32 rows at a time).
  Under these configs that residue reads larger than at gbm.yaml's
  settings in test_torch_train.py: the bias gradients cancel more (the
  sum of |cotangent| is 26-37x the largest gradient under kirc.yaml, 5x
  under lgg.yaml), so SHIPPED_RESIDUE holds each at twice its reading.
  Beside it the port's bias gradient is held within one bf16 rounding
  (2^-8 of its largest) of the float64 sum of its own cotangent rows, so
  the residue is JAX's order of additions, not the port's.
"""
import dataclasses
import functools
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.models.multilevel_gnn import MultilevelGNN as JModel
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu.train import step as jstep
from multilevel_gnn_tpu.train.driver import iter_batches as j_iter_batches
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.interop import load_flax_params, state_dict_from_flax
from multilevel_gnn_tpu_torch.data.synthetic import write_reference_format
from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
from multilevel_gnn_tpu_torch.train import step as pstep
from multilevel_gnn_tpu_torch.train.driver import iter_batches
from multilevel_gnn_tpu_torch.train.step import eval_step

from test_torch_slice import B, G, P, _cfg_dict, make_fold
from test_torch_train import TOL_BF16_GRAD, TOL_BF16_LOSS
from torch_threads import few_threads  # noqa: F401  (autouse)

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
SHIPPED = ("kirc", "lgg")
# the fold's node / pathway counts and the small widths, as _cfg_dict sets them
SMALL = ("node_num", "pathway_num", "hidden_channels", "final_channels",
         "node_embedding_dim", "conv_channel_list", "head_dim", "batch_size")
NO_DROPOUT = dict(feature_drop=False, head_drop_rate=0.0, gnn_dropout=0.0)
STEPS = 5
TOL_F32 = 1e-5
TOL_BF16_EVAL = 1e-5  # test_torch_slice.py's bf16 trunk bound
# F3 residue 1 under the shipped configs, max|diff| / max|grad| of the first
# step against JAX under jit: twice the readings (kirc 7.35e-2, 7.23e-2; lgg
# 1.58e-2, 6.8e-3)
SHIPPED_RESIDUE = {
    "kirc": {"gnn_0.gconv.nn.Linear_0.bias": 1.5e-1, "gnn_1.gconv.nn.Linear_0.bias": 1.45e-1},
    "lgg": {"gnn_0.gconv.nn.Linear_0.bias": 3.2e-2, "gnn_1.gconv.nn.Linear_0.bias": 1.4e-2},
}
TOL_BIAS_F64 = 2.0 ** -8  # one bf16 rounding of the sum, of its largest
TRUNK_BIASES = tuple(f"gnn_{i}.gconv.nn.Linear_0" for i in (0, 1))
CW = np.array([1.0, 1.7], np.float32)


def configs(name, bf16):
    """(JAX config, port config) of configs/<name>.yaml at the fold's small
    widths, dropout off; the f32 trunk unless bf16."""
    small = _cfg_dict()
    kw = {k: small[k] for k in SMALL}
    kw.update(NO_DROPOUT)
    if not bf16:
        kw.update(compute_dtype=None, spmm_bf16=False)
    path = str(CONFIGS / f"{name}.yaml")
    return JConfig.from_yaml(path, **kw), Config.from_yaml(path, **kw)


@functools.lru_cache(maxsize=None)
def _fold():
    return make_fold()


def _jax_batches(fold):
    return list(j_iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B,
                               np.random.RandomState(0), False, False))


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


@functools.lru_cache(maxsize=None)
def run(name, bf16):
    """Both packages from one flax init under configs/<name>.yaml: eval
    probabilities and losses of every batch, the first step's gradients
    (JAX under jit) with the float64 sums of the port's trunk MLP bias
    cotangents, and five train steps' losses."""
    fold = _fold()
    jcfg, pcfg = configs(name, bf16)
    jb = _jax_batches(fold)
    pb = list(iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B, "cpu"))
    jmodel = JModel(jcfg)
    jctx, pctx = fold["jctx"], fold["pctx"]
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    jspmm.set_spmm_dtype(jnp.bfloat16 if bf16 else None)
    try:
        fns = jstep.build_train_fns(jmodel, jcfg)
        params, opt_state = fns.init_state(jax.random.PRNGKey(0), jb[0], jctx, len(jb))
        flat0 = _flat(params)
        jeval = [fns.eval_step(params, b, jctx) for b in jb]
        loss_fn = jstep.make_loss_fn(jmodel, jcfg)
        g0 = jax.jit(jax.grad(lambda p: loss_fn(p, jb[0], jctx, jnp.asarray(CW),
                                                jax.random.PRNGKey(0))[0]))(params)
        jl = []
        for i in range(STEPS):
            params, opt_state, loss = fns.train_step(
                params, opt_state, jb[i % len(jb)], jctx, jnp.asarray(CW),
                jax.random.PRNGKey(i))
            jl.append(float(loss))
    finally:
        jspmm.set_backend(prev)
        jspmm.set_spmm_dtype(None)

    model = MultilevelGNN(pcfg, fold["n"], G, device="cpu")
    load_flax_params(model, flat0)
    peval = [eval_step(model, b, pctx) for b in pb]
    sums = {}

    def keep_sum(name):
        def hook(module, inputs, out):
            out.register_hook(lambda g: sums.__setitem__(
                name + ".bias", g.detach().double().reshape(-1, g.shape[-1]).sum(0).numpy()))
        return hook

    hooks = [model.get_submodule(n).register_forward_hook(keep_sum(n)) for n in TRUNK_BIASES]
    model.train()
    loss, _ = pstep.make_loss_fn(pcfg)(model, pb[0], pctx, torch.from_numpy(CW),
                                       torch.Generator().manual_seed(0))
    loss.backward()
    pgrad = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    for h in hooks:
        h.remove()
    model.zero_grad(set_to_none=True)
    opt = pstep.make_optimizer(model, pcfg, len(pb))
    gen = torch.Generator().manual_seed(0)
    pl = [float(pstep.train_step(model, opt, pb[i % len(pb)], pctx,
                                 torch.from_numpy(CW), gen)) for i in range(STEPS)]
    return dict(
        jp=np.stack([np.asarray(p) for p, _ in jeval]).astype(np.float64),
        jel=np.array([float(l) for _, l in jeval]),
        pp=np.stack([p.numpy() for p, _ in peval]).astype(np.float64),
        pel=np.array([float(l) for _, l in peval]),
        jgrad={k: np.asarray(v) for k, v in state_dict_from_flax(_flat(g0)).items()},
        pgrad=pgrad, bias_f64=sums, jl=np.array(jl), pl=np.array(pl), cfg=pcfg, model=model,
    )


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_options_read_alike(name):
    path = str(CONFIGS / f"{name}.yaml")
    jcfg, pcfg = JConfig.from_yaml(path), Config.from_yaml(path)
    jf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    pf = {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)}
    assert set(jf) <= set(pf), set(jf) - set(pf)
    assert {k: v for k, v in pf.items() if k in jf} == jf
    gbm = Config.from_yaml(str(CONFIGS / "gbm.yaml"))
    assert (pcfg.batch_size, pcfg.pca_dim, pcfg.pca_sim_dim, pcfg.head_dim) == (64, 3, 3, 512)
    assert pcfg.reorder_pathway and pcfg.mutual_neighbors == 15 and pcfg.risk_threshold == 36
    assert (pcfg.lr, pcfg.step) == (5e-5, 140)
    # onehot global edges are the default, in gbm.yaml's config too
    assert pcfg.global_edge == gbm.global_edge == "onehot"
    # B x node_embedding_dim and B x hidden: the two SAGE layers' SpMM widths
    assert (pcfg.batch_size * pcfg.node_embedding_dim,
            pcfg.batch_size * pcfg.hidden_channels) == (2048, 4096)
    if name == "kirc":
        assert pcfg.selected_similarity and not pcfg.use_age
        assert (pcfg.pathway_pool_dim, pcfg.pca_pool_dim) == (1, 1)
    else:
        assert not pcfg.selected_similarity and pcfg.use_age and pcfg.pre_concat_age
        assert (pcfg.pathway_pool_dim, pcfg.pca_pool_dim) == (4, 2)
    assert pcfg.spmm_bf16 and pcfg.windowed_spmm and pcfg.compute_dtype == "bfloat16"


def test_reference_files_do_not_depend_on_cancer_type(tmp_path):
    for ct in ("gbm",) + SHIPPED:
        write_reference_format(str(tmp_path / ct), seed=2, cancer_type=ct,
                               n_patients=30, n_pathways=4)
    files = sorted((tmp_path / "gbm" / "gbm").iterdir())
    assert len(files) == 5
    for f in files:
        for ct in SHIPPED:
            assert (tmp_path / ct / ct / f.name).read_bytes() == f.read_bytes(), (ct, f.name)


def test_fold_has_the_paths_the_configs_run():
    fold = _fold()
    wp = fold["pctx"].graph.winplan
    assert wp is not None and wp.n_res > 0
    reorder = fold["pctx"].reorder_idxs.numpy()
    assert not np.array_equal(reorder, np.arange(len(reorder)))


@pytest.mark.parametrize("name", SHIPPED)
def test_eval_f32_matches_jax(name):
    r = run(name, False)
    assert r["pp"].shape == (-(-P // B), B, 2) and np.isfinite(r["pp"]).all()
    np.testing.assert_allclose(r["pp"], r["jp"], rtol=0, atol=TOL_F32)
    np.testing.assert_allclose(r["pel"], r["jel"], rtol=0, atol=TOL_F32)


@pytest.mark.parametrize("name", SHIPPED)
def test_five_train_steps_f32_match_jax(name):
    r = run(name, False)
    assert np.isfinite(r["pl"]).all()
    np.testing.assert_allclose(r["pl"], r["jl"], rtol=0, atol=TOL_F32)


@pytest.mark.parametrize("name", SHIPPED)
def test_eval_bf16_within_bound(name):
    r = run(name, True)
    assert r["cfg"].compute_dtype == "bfloat16" and r["cfg"].spmm_bf16
    assert np.isfinite(r["pp"]).all()
    np.testing.assert_allclose(r["pp"], r["jp"], rtol=0, atol=TOL_BF16_EVAL)
    np.testing.assert_allclose(r["pel"], r["jel"], rtol=0, atol=TOL_BF16_EVAL)


@pytest.mark.parametrize("name", SHIPPED)
def test_five_train_steps_bf16_within_bound(name):
    r = run(name, True)
    assert np.isfinite(r["pl"]).all()
    np.testing.assert_allclose(r["pl"], r["jl"], rtol=0, atol=TOL_BF16_LOSS)


@pytest.mark.parametrize("name", SHIPPED)
def test_first_step_bf16_gradients_within_bound(name):
    r = run(name, True)
    jg, pg = r["jgrad"], r["pgrad"]
    assert set(jg) == set(pg)
    for n, g in jg.items():
        rel = np.abs(pg[n] - g).max() / max(np.abs(g).max(), 1e-30)
        assert rel <= SHIPPED_RESIDUE[name].get(n, TOL_BF16_GRAD), (n, rel)


@pytest.mark.parametrize("name", SHIPPED)
def test_bf16_bias_gradients_within_one_rounding_of_float64(name):
    r = run(name, True)
    assert set(r["bias_f64"]) == set(SHIPPED_RESIDUE[name])
    for n, exact in r["bias_f64"].items():
        rel = np.abs(r["pgrad"][n].astype(np.float64) - exact).max() / np.abs(exact).max()
        assert rel <= TOL_BIAS_F64, (n, rel)


@pytest.mark.parametrize("name", SHIPPED)
def test_head_convolutions_run_without_tf32(name, monkeypatch):
    """The head's convolutions own their precision: with torch's default
    torch.backends.cudnn.allow_tf32 (True), each forward and backward
    convolution of a train step runs with TF32 off (on the card, cuDNN
    would otherwise round some algorithms' f32 inputs to TF32), and the
    flag is as it was afterwards."""
    assert torch.backends.cudnn.allow_tf32
    seen = {"forward": [], "backward": []}
    conv2d, conv_bwd = torch.nn.functional.conv2d, torch.ops.aten.convolution_backward

    def record(kind, fn):
        def call(*args, **kwargs):
            seen[kind].append(torch.backends.cudnn.allow_tf32)
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(torch.nn.functional, "conv2d", record("forward", conv2d))
    monkeypatch.setattr(torch.ops.aten, "convolution_backward", record("backward", conv_bwd))
    fold = _fold()
    _, pcfg = configs(name, False)
    model = MultilevelGNN(pcfg, fold["n"], G, device="cpu")
    pb = next(iter(iter_batches(fold["X"], fold["Y"], fold["ages"], np.arange(P), B, "cpu")))
    model.train()
    loss, _ = pstep.make_loss_fn(pcfg)(model, pb, fold["pctx"], torch.from_numpy(CW),
                                       torch.Generator().manual_seed(0))
    loss.backward()
    n_conv = len(pcfg.conv_channel_list)
    assert seen == {"forward": [False] * n_conv, "backward": [False] * n_conv}, seen
    assert torch.backends.cudnn.allow_tf32
