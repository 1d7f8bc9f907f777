"""The max-aggregation convs of the PyTorch port (MRConv, EdgeConv) and the
MultilevelGNN that runs them (gnn_name mr / edge) against the JAX package
on the 'pallas' backend (flat_segment_max and flat_segment_sum in
interpret mode).  Parameters are initialised by flax and carried into the
port through interop.load_flax_params.

- GraphConvLayer(conv="mr" / "edge") on a self-looped graph with padding
  edges and on a graph without self loops (empty rows): the output and
  the gradients to x and to every parameter, against jax.vjp.
- MultilevelGNN on the small fold of test_torch_slice.py: eval-mode
  probabilities and eval_step loss over three batches; five train steps
  (dropout off) from the same flax params, as
  test_torch_train.py::test_five_train_steps_f32_match_jax holds them.
- mr and edge ignore gnn_mlp_norm and gnn_dropout, as JAX's GraphConvLayer
  does; the convs that are not ported yet raise.

Tolerances:
  f32:  max|port - jax| <= 1e-5 * max(1, max|jax|) (layers; the model's
        probabilities and losses: atol 1e-5; parameters after five steps:
        2 * lr * steps, and 1e-5 where JAX's first gradient is above 1e-3
        of its parameter's largest).
  bf16 trunk: max|port_bf16 - jax_f32| <= 1.5 * max|jax_bf16 - jax_f32|
        + 1e-3, per compared tensor.
"""
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.graph import Graph as JGraph
from multilevel_gnn_tpu.nn.conv import GraphConvLayer as JLayer
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.interop import load_flax_params, state_dict_from_flax
from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
from multilevel_gnn_tpu_torch.nn.conv import GraphConvLayer

from test_torch_slice import G, N_GENES, _cfg_dict, _run, fold  # noqa: F401
from test_torch_train import LR, STEPS, _train
from torch_threads import few_threads  # noqa: F401  (autouse)

CONVS = ["mr", "edge"]
CIN, COUT, B = 6, 5, 3


def _f32_close(out, ref):
    assert np.abs(out - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


def _bf16_within(p16, j16, j32):
    assert np.abs(p16 - j32).max() <= 1.5 * np.abs(j16 - j32).max() + 1e-3


def _graph(loops):
    rng = np.random.RandomState(3 if loops else 4)
    n, e = 80, 420
    ei = np.stack([rng.randint(0, n, e), rng.randint(0, n - (0 if loops else 12), e)])
    attr = (rng.rand(e) + 0.1).astype(np.float32)
    jg, pg = JGraph.from_edges(ei, attr, n), Graph.from_edges(ei, attr, n)
    if loops:
        jg, pg = jg.with_self_loops(), pg.with_self_loops()
    pad_to = jg.n_edges + 23
    return (n, jg.pad_edges_to(pad_to).with_sorted_meta(),
            pg.pad_edges_to(pad_to).with_sorted_meta("cpu"))


@functools.lru_cache(maxsize=None)
def _layer_grads(conv, loops, bf16):
    """(out, dx, {param: grad}) of the JAX layer and of the port's, float64,
    in JAX's (B, N, C) layout."""
    n, jg, pg = _graph(loops)
    rng = np.random.RandomState(5)
    x = rng.randn(B, n, CIN).astype(np.float32)
    g = rng.randn(B, n, COUT).astype(np.float32)
    dt = jnp.bfloat16 if bf16 else None
    jl = JLayer(CIN, COUT, conv=conv, act_type="leakyrelu", dtype=dt)
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    try:
        params = jax.jit(lambda k, a: jl.init(k, a, jg, jg.edge_attr))(
            jax.random.PRNGKey(1), jnp.asarray(x))

        def f(p, a, c):
            out, vjp = jax.vjp(lambda p, a: jl.apply(p, a, jg, jg.edge_attr), p, a)
            return (out,) + vjp(c.astype(out.dtype))

        out, jp_grad, jdx = jax.jit(f)(params, jnp.asarray(x), jnp.asarray(g))
    finally:
        jspmm.set_backend(prev)
    flat = {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(params, sep="/").items()}
    jgrads = state_dict_from_flax(
        {k: np.asarray(v, np.float32) for k, v in
         flax.traverse_util.flatten_dict(jp_grad, sep="/").items()})
    layer = GraphConvLayer(CIN, COUT, conv=conv, act_type="leakyrelu",
                           dtype=torch.bfloat16 if bf16 else None)
    load_flax_params(layer, flat)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2))).requires_grad_(True)
    po = layer(xt, pg, pg.edge_attr)
    # the dtype flow of conv.py:467 / :505: mr ends in its MLP, edge in K3
    assert po.dtype == (torch.float32 if conv == "edge" or not bf16 else torch.bfloat16)
    assert po.dtype == torch.float32 or str(out.dtype) == "bfloat16"
    po.backward(torch.from_numpy(np.ascontiguousarray(g.transpose(1, 0, 2))).to(po.dtype))
    port = (po.detach().float().numpy().transpose(1, 0, 2).astype(np.float64),
            xt.grad.numpy().transpose(1, 0, 2).astype(np.float64),
            {k: p.grad.numpy().astype(np.float64) for k, p in layer.named_parameters()})
    ref = (np.asarray(out, np.float64), np.asarray(jdx, np.float64),
           {k: v.numpy().astype(np.float64) for k, v in jgrads.items()})
    return port, ref


@pytest.mark.parametrize("loops", [True, False], ids=["self_loops", "empty_rows"])
@pytest.mark.parametrize("conv", CONVS)
def test_conv_layer_f32_matches_jax(conv, loops):
    (po, pdx, pgr), (jo, jdx, jgr) = _layer_grads(conv, loops, bf16=False)
    _f32_close(po, jo)
    _f32_close(pdx, jdx)
    assert set(pgr) == set(jgr) == {"gconv.nn.Linear_0.weight", "gconv.nn.Linear_0.bias"}
    for k in pgr:
        _f32_close(pgr[k], jgr[k])


@pytest.mark.parametrize("conv", CONVS)
def test_conv_layer_bf16_within_bound(conv):
    (po, pdx, pgr), (jo32, jdx32, jgr32) = _layer_grads(conv, True, bf16=False)
    (p16, pdx16, pgr16), (j16, jdx16, jgr16) = _layer_grads(conv, True, bf16=True)
    _bf16_within(p16, j16, jo32)
    _bf16_within(pdx16, jdx16, jdx32)
    for k in pgr16:
        _bf16_within(pgr16[k], jgr16[k], jgr32[k])


@pytest.fixture(scope="module")
def runs(fold):
    return {(c, bf16): _run(fold, bf16, gnn_name=c) for c in CONVS for bf16 in (False, True)}


@pytest.mark.parametrize("conv", CONVS)
def test_model_eval_f32_matches_jax(runs, conv):
    r = runs[(conv, False)]
    assert np.isfinite(r["pp"]).all()
    np.testing.assert_allclose(r["pp"], r["jp"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(r["pl"], r["jl"], rtol=0, atol=1e-5)
    assert r["model"].gnn_1.gconv.__class__.__name__ == {"mr": "MRConv", "edge": "EdgeConv"}[conv]


@pytest.mark.parametrize("conv", CONVS)
def test_model_eval_bf16_within_bound(runs, conv):
    f, h = runs[(conv, False)], runs[(conv, True)]
    _bf16_within(h["pp"], h["jp"], f["jp"])
    _bf16_within(h["pl"], h["jl"], f["jl"])


@pytest.mark.parametrize("conv", CONVS)
def test_five_train_steps_f32_match_jax(fold, conv):
    jl, pl, model, ref, flat0, grad0 = _train(fold, bf16=False, windowed=True, gnn_name=conv)
    assert np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-5)
    want = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        diff = (p - want[name]).abs().detach()
        assert float(diff.max()) <= 2 * LR * STEPS, (name, float(diff.max()))
        g = grad0[name].abs()
        clear = g > 1e-3 * float(g.max())
        if bool(clear.any()):
            assert float(diff[clear].max()) <= 1e-5, (name, float(diff[clear].max()))
    start = MultilevelGNN(model.cfg, fold["n"], G, device="cpu")
    load_flax_params(start, flat0)
    assert max(float((p - q).abs().max().detach()) for p, q in
               zip(model.parameters(), start.parameters())) > LR  # it trained


@pytest.mark.parametrize("conv", CONVS)
def test_mr_edge_ignore_mlp_norm_and_dropout(conv):
    cfg = Config.from_dict(_cfg_dict(gnn_name=conv, gnn_mlp_norm="batch",
                                     gnn_dropout=0.5, gnn_last_norm=True))
    model = MultilevelGNN(cfg, 3 * N_GENES, G, device="cpu")
    for i in range(model.n_layers):
        mlp = getattr(model, f"gnn_{i}").gconv.nn
        assert mlp.drop.rate == 0.0
    with pytest.raises(NotImplementedError):  # a string norm is the MLP norm
        MultilevelGNN(cfg.replace(gnn_last_norm="batch"), 3 * N_GENES, G, device="cpu")


@pytest.mark.parametrize("conv", ["gat", "gcn", "gin", "gen"])
def test_unported_convs_raise(conv):
    with pytest.raises(NotImplementedError):
        MultilevelGNN(Config.from_dict(_cfg_dict(gnn_name=conv)), 3 * N_GENES, G,
                      device="cpu")
