"""MultiOmixGCN in the PyTorch port against the JAX package, on the CPU
(PathwayConv and multiomix_vnode_data: test_torch_pathway_conv.py).

The setup is tests/test_deepergcn_multiomix.py's: both packages'
30-patient, 8-pathway synthetic cohort (seed 0), DeeperGCN's fold over the
first 18 patients, the per-omics vnode data, gbm-like DeeperGCN choices at
hidden 16 (res+, softmax with learned t, layer norm, node embedding,
edge encoders, maxpool readout, two head layers), f32.  JAX runs on its
'pallas' backend (Pallas in interpret mode) under jit; its parameters go
through interop.py into the port, which runs its plain versions on the
CPU.  The batch's ages are scaled by 1/100 on both sides, so the softmax
head is not saturated.  Limits: max|diff| / max(1, max|ref|) <= 1e-5.

- MultiOmixGCN eval for blocks res+ / res / plain and readouts None / MSA /
  maxpool (four cases): probabilities and each omics encoder's output; the
  parameter trees match (interop loads every flax leaf and no other).
- The VJP of the class-weighted BCE in training mode (dropout 0, t not
  learned), softmax and max: every parameter's gradient.
- The registry's three names, and the train CLI's AttributeError, as JAX's.
"""
import functools
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.batch import Batch as JBatch
from multilevel_gnn_tpu.data.synthetic import make_synthetic_cohort as j_make_cohort
from multilevel_gnn_tpu.models.multiomix import DeeperGCNVnode as JVnode
from multilevel_gnn_tpu.models.multiomix import MultiOmixGCN as JModel
from multilevel_gnn_tpu.models.multiomix import VnodeContext as JVctx
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu.train import cli as jcli
from multilevel_gnn_tpu.train.step import classification_loss as j_loss
from multilevel_gnn_tpu_torch.core.batch import Batch
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.data.synthetic import make_synthetic_cohort
from multilevel_gnn_tpu_torch.interop import load_flax_params, state_dict_from_flax
from multilevel_gnn_tpu_torch.models import get_model
from multilevel_gnn_tpu_torch.models.multiomix import MultiOmixGCN, VnodeContext
from multilevel_gnn_tpu_torch.train import cli
from multilevel_gnn_tpu_torch.train.step import classification_loss
from test_data_pipeline import gbm_like_cfg
from torch_threads import few_threads  # noqa: F401  (autouse)

TOL = 1e-5
B = 4
GBM = str(Path(__file__).resolve().parents[1] / "configs" / "gbm.yaml")
CFG = dict(model="deepergcn", conv="gen", gcn_aggr="softmax", block="res+", num_layers=3,
           hidden_channels=16, mlp_layers=2, norm="layer", node_embedding=True,
           node_embedding_dim=4, use_edge_attr=True, global_edge="onehot",
           pathway_readout="maxpool", graph_pooling="mean", num_layer_head=2,
           pre_concat_age=True, dropout=0.25, learn_t=True, kernel_backend="pallas")


def rel_err(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(1.0, float(np.abs(ref).max())))


def flat(tree):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def pallas(fn):
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    try:
        return fn()
    finally:
        jspmm.set_backend(prev)


def port_cfg(jcfg) -> Config:
    return Config.from_dict({f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})


@functools.lru_cache(maxsize=None)
def setup():
    jcfg = gbm_like_cfg(**CFG)
    jc = j_make_cohort(jcfg, seed=0, n_patients=30, n_pathways=8)
    jcfg = jcfg.replace(pathway_num=jc.n_pathways, node_num=jc.node_size + jc.n_pathways)
    pc = make_synthetic_cohort(port_cfg(jcfg), seed=0, n_patients=30, n_pathways=8)
    train = np.arange(18)
    jf, pf = jc.deepergcn_fold(train, 0), pc.deepergcn_fold(train, 0, device="cpu")
    jcfg = jcfg.replace(pathway_edge_num=max(jc.pathway_edge_num, 1))
    jdata, pdata = jc.multiomix_vnode_data(jf), pc.multiomix_vnode_data(pf, device="cpu")
    X = jc.gene_level_features()[:B]
    ages = (np.asarray(jc.ages[:B]) / 100.0).astype(np.float32)
    Y = np.asarray(jc.Y[:B], np.float32)
    jb = JBatch(x=jnp.asarray(X), y=jnp.asarray(Y), age=jnp.asarray(ages),
                sample_mask=jnp.ones(B, bool))
    pb = Batch(x=torch.as_tensor(X), y=torch.as_tensor(Y), age=torch.as_tensor(ages),
               sample_mask=torch.ones(B, dtype=torch.bool))
    jv = JVctx(base=jf.ctx, pathway_graphs=jdata[0], pathway_masks=jdata[1])
    pv = VnodeContext(pf.ctx, pdata[0], pdata[1])
    ja = {k: v[:B] for k, v in jdata[2].items()}
    pa = {k: v[:B] for k, v in pdata[2].items()}
    return dict(jcfg=jcfg, jc=jc, pc=pc, jf=jf, pf=pf, jdata=jdata, pdata=pdata, jb=jb,
                pb=pb, jv=jv, pv=pv, ja=ja, pa=pa)


# ------------------------------------------------------------------ model
EVAL_CASES = [
    dict(block="res+", pathway_readout="maxpool", gcn_aggr="softmax"),
    dict(block="res+", pathway_readout=None, gcn_aggr="max"),
    dict(block="res", pathway_readout="MSA", gcn_aggr="max"),
    dict(block="plain", pathway_readout="maxpool", gcn_aggr="softmax"),
]


def _pair(**kw):
    s = setup()
    jcfg = s["jcfg"].replace(**kw)
    jm = JModel(jcfg)
    params = pallas(lambda: jax.jit(jm.init, static_argnums=4)(
        jax.random.PRNGKey(0), s["jb"], s["jv"], s["ja"], False))
    pm = MultiOmixGCN.for_vnode_data(port_cfg(jcfg), s["pdata"][0], s["pa"], device="cpu")
    load_flax_params(pm, flat(params))
    return s, jcfg, jm, params, pm


@pytest.mark.parametrize("case", EVAL_CASES, ids=lambda c: f"{c['block']}-"
                         f"{c['pathway_readout'] or 'mean'}-{c['gcn_aggr']}")
def test_eval_matches_jax(case):
    s, jcfg, jm, params, pm = _pair(**case)
    (jp, _), inter = pallas(lambda: jax.jit(lambda p: jm.apply(
        p, s["jb"], s["jv"], s["ja"], False, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, JVnode)))(params))
    pm.eval()
    with torch.no_grad():
        pp, aux = pm(s["pb"], s["pv"], s["pa"])
        assert aux is None and pp.shape == (B, 2)
        assert rel_err(pp.numpy(), jp) <= TOL
        for omix in ("mrna", "cnv", "mt"):
            (jh,) = inter["intermediates"][f"{omix}_encoder"]["__call__"]
            ph = getattr(pm, f"{omix}_encoder")(s["pb"], s["pv"], s["pa"][omix])
            assert rel_err(ph.numpy(), jh) <= TOL, omix
    names = set(dict(pm.named_parameters()))
    assert not any(n.startswith(f"{o}_encoder.pathway_gcn_0") for o in ("mrna", "cnv", "mt")
                   for n in names)
    assert any(".pathway_gcn_" in n for n in names) == (case["block"] == "res+")


@pytest.mark.parametrize("aggr", ["softmax", "max"])
def test_loss_vjp_matches_jax(aggr):
    # learn_t off: with it, JAX's gradients on this cohort are NaN upstream
    # of the pathway rows (ROADMAP section 3), the port's finite
    s, jcfg, jm, params, pm = _pair(dropout=0.0, learn_t=False, gcn_aggr=aggr)
    cw = np.array([1.0, 1.7], np.float32)
    jcw = jnp.asarray(cw)

    def loss(p):
        pred, _ = jm.apply(p, s["jb"], s["jv"], s["ja"], True)
        return j_loss(pred, s["jb"].y, jcw, s["jb"].sample_mask, jcfg)

    jl, jg = pallas(lambda: jax.jit(jax.value_and_grad(loss))(params))
    pm.train()
    pred, _ = pm(s["pb"], s["pv"], s["pa"])
    pl = classification_loss(pred, s["pb"].y, torch.as_tensor(cw), s["pb"].sample_mask,
                             port_cfg(jcfg))
    pl.backward()
    assert abs(float(pl.detach()) - float(jl)) <= TOL * max(1.0, abs(float(jl)))
    want = state_dict_from_flax(flat(jg))
    got = dict(pm.named_parameters())
    assert sorted(want) == sorted(got)
    for name, g in want.items():
        assert got[name].grad is not None, name
        assert rel_err(got[name].grad.numpy(), g.numpy()) <= TOL, name


def test_registry_names():
    for name in ("multiomix", "mulitomix_gcn", "multiomix_gcn"):
        assert get_model(name) is MultiOmixGCN


def test_train_cli_fails_as_jax_does():
    argv = ["--config", GBM, "--synthetic", "--debug", "--set", "model=multiomix", "epochs=1"]
    with pytest.raises(AttributeError) as je:
        jcli.main(argv)
    with pytest.raises(AttributeError) as pe:
        cli.main(argv + ["--device", "cpu"])
    assert "has no attribute 'get'" in str(je.value) and "has no attribute 'get'" in str(pe.value)
