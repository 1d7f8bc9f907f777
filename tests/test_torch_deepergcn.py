"""DeeperGCN's aggregation ops and layers in the PyTorch port against the
JAX package on the 'pallas' backend (its Pallas kernels in interpret mode),
with the weights carried over by interop.py.

- edge_segment_sum (K1 over dst_gather, unit weights) and
  segment_softmax_weights (the global-max shift), forward and gradient
  against jax.vjp under jit, on edge-major (E, B, C) rows with padding
  edges, empty rows and a segment far below the column maximum, whose
  denominator underflows to 0 (weights 0, as JAX gives).
- GENConv (gather_src, the edge encoder, relu + eps, GenAggregate, MsgNorm,
  the feature encoder MLP with a LayerNorm and last_lin) for each of the
  eight aggregators, with their learnables (t, p, y, msg_scale) off and on:
  output and the gradients to x, to the edge features and to every
  parameter against jax.vjp under jit; the gnn_encoder 'conv1x1' form and
  pca_only.
- Norm (layer, instance, none, batch in eval; batch in training raises as
  flax does) and MLP with norms and last_lin.
- A flax DeeperGCN's parameters (and batch_stats) map onto the port's, no
  key left over, no shape apart; get_model names the ported models.
- bf16 GENConv: test_torch_deepergcn_bf16.py.

Tolerance: 1e-5 * max(1, max|ref|) per tensor (f32); the bf16 Norm in
eval: equal (one cast of the same float32 value).
"""
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.graph import Graph as JGraph
from multilevel_gnn_tpu.nn.basic import MLP as JMLP
from multilevel_gnn_tpu.nn.basic import Norm as JNorm
from multilevel_gnn_tpu.nn.conv import GENConv as JGENConv
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.interop import load_flax_params, state_dict_from_flax
from multilevel_gnn_tpu_torch.models import get_model
from multilevel_gnn_tpu_torch.nn.basic import MLP, Norm
from multilevel_gnn_tpu_torch.nn.conv import GENConv
from multilevel_gnn_tpu_torch.ops import spmm
from torch_threads import few_threads  # noqa: F401  (autouse)

N, E, PAD, EMPTY, B, C = 90, 500, 17, 10, 3, 8
# bf16 GENConv's output against JAX's jitted bf16, max|diff| / max(1,
# max|ref|): twice the worst reading over LAYER_CASES of
# tests/torch_deepergcn_report.py (1.14e-2; JAX eager against JAX jit reads
# the same); the backward is held to JAX eager (test_torch_deepergcn_bf16.py)
BF16_LAYER_RESIDUE = {"out": 2.3e-2}


def _close(out, ref, tol=1e-5):
    """Within tol * max(1, max|ref|); NaN where the reference has NaN (the
    norm's gradient at an all-zero row, MsgNorm on an empty segment)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    ok = ~np.isnan(ref)
    if ok.any():
        err, big = np.abs(out[ok] - ref[ok]).max(), np.abs(ref[ok]).max()
        assert err <= tol * max(1.0, big), (err, big)


@functools.lru_cache(maxsize=None)
def _graphs():
    """A graph with padding edges, EMPTY rows without in-edges and 2-column
    edge attrs, on both sides."""
    rng = np.random.RandomState(7)
    ei = np.stack([rng.randint(0, N, E), rng.randint(0, N - EMPTY, E)])
    attr = np.stack([rng.rand(E), rng.randint(0, 4, E)], axis=1).astype(np.float32)
    jg = JGraph.from_edges(ei, attr, N, pad_to=E + PAD).with_sorted_meta()
    pg = Graph.from_edges(ei, attr, N, pad_to=E + PAD).with_sorted_meta("cpu")
    return jg, pg


def _nm(a):
    """(B, M, ...) JAX layout -> (M, B, ...) port layout, and back."""
    return np.ascontiguousarray(np.swapaxes(np.asarray(a), 0, 1))


def _pallas(fn):
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    try:
        return fn()
    finally:
        jspmm.set_backend(prev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_segment_sum_matches_jax(dtype):
    jg, pg = _graphs()
    rng = np.random.RandomState(1)
    msg = rng.randn(B, E + PAD, C).astype(np.float32)
    msg[:, E:] = 1e4  # padding rows take no part
    g = rng.randn(B, N, C).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def f(m, c):
        out, vjp = jax.vjp(lambda m: jspmm.edge_segment_sum(
            m, jg.receivers, jg.edge_mask, jg.csr), m)
        return out, vjp(c)[0]

    jo, jd = _pallas(lambda: jax.jit(f)(jnp.asarray(msg, jdt), jnp.asarray(g)))
    mt = torch.from_numpy(_nm(np.asarray(jnp.asarray(msg, jdt).astype(jnp.float32))))
    mt = mt.to(getattr(torch, dtype)).requires_grad_(True)
    po = spmm.edge_segment_sum(mt, pg)
    assert po.dtype == torch.float32 and po.shape == (N, B, C)
    po.backward(torch.from_numpy(_nm(g)))
    assert mt.grad.dtype == mt.dtype
    _close(_nm(po.detach().numpy()), jo)
    _close(_nm(mt.grad.float().numpy()), np.asarray(jd, np.float32))
    assert float(po.detach()[N - EMPTY:].abs().max()) == 0.0
    assert float(mt.grad[E:].abs().max()) == 0.0


def test_segment_softmax_weights_matches_jax_with_underflow():
    jg, pg = _graphs()
    rng = np.random.RandomState(2)
    z = rng.randn(B, E + PAD, C).astype(np.float32)
    recv = np.asarray(jg.receivers)
    low = recv == recv[0]  # one segment far below its columns' maxima
    z[:, low] -= 200.0
    z[:, E:] = 50.0  # padding never sets the shift
    g = rng.randn(B, E + PAD, C).astype(np.float32)

    def f(z, c):
        out, vjp = jax.vjp(lambda z: jspmm.segment_softmax_weights(z, jg), z)
        return out, vjp(c)[0]

    jw, jd = _pallas(lambda: jax.jit(f)(jnp.asarray(z), jnp.asarray(g)))
    zt = torch.from_numpy(_nm(z)).requires_grad_(True)
    pw = spmm.segment_softmax_weights(zt, pg)
    pw.backward(torch.from_numpy(_nm(g)))
    _close(_nm(pw.detach().numpy()), jw)
    _close(_nm(zt.grad.numpy()), jd)
    w = pw.detach().numpy()
    assert np.abs(w[low[: E + PAD]]).max() == 0.0  # underflowed: weight 0
    assert np.abs(w[E:]).max() == 0.0
    sums = np.zeros((N, B, C))
    np.add.at(sums, recv[:E], w[:E])
    busy = np.setdiff1d(np.unique(recv[:E]), [recv[0]])
    np.testing.assert_allclose(sums[busy], 1.0, rtol=0, atol=1e-5)


def test_jax_backends_differ_where_a_segment_underflows():
    """On the input of the test above, JAX's 'xla' backend shifts each
    segment by its own maximum (ops/segment.py:108) and gives the low
    segment weights summing to 1; the 'pallas' form, which the shipped
    configs take and the port follows, gives it 0 (ROADMAP section 3)."""
    from multilevel_gnn_tpu.ops import segment as jseg

    jg, pg = _graphs()
    rng = np.random.RandomState(2)
    z = rng.randn(B, E + PAD, C).astype(np.float32)
    recv = np.asarray(jg.receivers)
    low = recv == recv[0]
    z[:, low] -= 200.0
    xla = np.asarray(jseg.segment_softmax(jnp.asarray(z), jg.receivers, N,
                                          mask=jg.edge_mask))
    port = spmm.segment_softmax_weights(torch.from_numpy(_nm(z)), pg).numpy()
    low_real = low & np.asarray(jg.edge_mask)
    np.testing.assert_allclose(xla[:, low_real].sum(1), 1.0, rtol=0, atol=1e-5)
    assert np.abs(port[low_real]).max() == 0.0
    other = ~low & np.asarray(jg.edge_mask)
    _close(_nm(port)[:, other], xla[:, other])


# (aggr, learn_t, learn_p, learn_y, msg_norm, learn_msg_scale)
LAYER_CASES = [
    ("add", False, False, False, False, False),
    ("sum", False, False, False, True, True),
    ("mean", False, False, False, False, False),
    ("max", False, False, False, True, False),
    ("softmax", False, False, False, False, False),
    ("softmax", True, False, False, False, False),
    ("softmax_sg", True, False, False, False, False),
    ("softmax_sum", False, False, False, False, False),
    ("softmax_sum", True, False, True, False, False),
    ("power", False, False, False, False, False),
    ("power", False, True, False, False, False),
    ("power_sum", False, True, True, False, False),
]
LAYER_IDS = ["-".join([c[0]] + [n for n, on in zip(("t", "p", "y", "msgnorm", "scale"), c[1:])
                                if on]) for c in LAYER_CASES]


@functools.lru_cache(maxsize=None)
def _layer(case, bf16, encoder="linear", pca_only=False):
    """GENConv on both sides from the same flax params: (port, jax) each
    (out, dx, de, {param: grad}) in the JAX layout, float64."""
    aggr, lt, lp, ly, mn, ls = case
    jg, pg = _graphs()
    rng = np.random.RandomState(3)
    x = rng.randn(B, N, C).astype(np.float32)
    e = rng.randn(E + PAD, C).astype(np.float32)
    g = rng.randn(B, N, C).astype(np.float32)
    kw = dict(aggr=aggr, t=0.7, learn_t=lt, p=1.3, learn_p=lp, y=0.2, learn_y=ly,
              msg_norm=mn, learn_msg_scale=ls, encode_edge=True, edge_feat_dim=C,
              norm_type="layer", mlp_layers=2, pca_only=pca_only, gnn_encoder=encoder)
    jl = JGENConv(C, C, dtype=jnp.bfloat16 if bf16 else None, **kw)

    def run():
        params = jax.jit(lambda k: jl.init(k, jnp.asarray(x), jg, jnp.asarray(e)))(
            jax.random.PRNGKey(4))

        def f(p, a, ea, c):
            out, vjp = jax.vjp(lambda p, a, ea: jl.apply(p, a, jg, ea), p, a, ea)
            return (out,) + vjp(c.astype(out.dtype))

        return params, jax.jit(f)(params, jnp.asarray(x), jnp.asarray(e), jnp.asarray(g))

    params, (jo, jp, jdx, jde) = _pallas(run)
    flat = {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(params, sep="/").items()}
    layer = GENConv(C, C, dtype=torch.bfloat16 if bf16 else None, **kw)
    load_flax_params(layer, flat)
    xt = torch.from_numpy(_nm(x)).requires_grad_(True)
    et = torch.from_numpy(e).requires_grad_(True)
    po = layer(xt, pg, et)
    po.backward(torch.from_numpy(_nm(g)).to(po.dtype))
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    jgr = state_dict_from_flax({k: np.asarray(v, np.float32) for k, v in
                                flax.traverse_util.flatten_dict(jp, sep="/").items()})
    port = (f64(_nm(po.detach().float().numpy())), f64(_nm(xt.grad.numpy())),
            f64(et.grad.numpy()) if et.grad is not None else np.zeros(e.shape),
            {k: f64(p.grad.numpy()) if p.grad is not None else np.zeros(p.shape)
             for k, p in layer.named_parameters()})
    ref = (f64(np.asarray(jo, np.float32)), f64(np.asarray(jdx, np.float32)),
           f64(np.asarray(jde, np.float32)), {k: f64(v.numpy()) for k, v in jgr.items()})
    return port, ref


@pytest.mark.parametrize("case", LAYER_CASES, ids=LAYER_IDS)
def test_genconv_f32_matches_jax(case):
    (po, pdx, pde, pgr), (jo, jdx, jde, jgr) = _layer(case, False)
    _close(po, jo)
    _close(pdx, jdx)
    _close(pde, jde)
    assert set(pgr) == set(jgr)
    for k in pgr:
        _close(pgr[k], jgr[k])
    aggr, lt, lp, ly, mn, ls = case
    learned = {k.split(".")[-1] for k in pgr if k.startswith(("aggregate", "msg_norm"))}
    want = set()
    want |= {"t"} if lt and aggr in ("softmax", "softmax_sum") else set()
    want |= {"p"} if lp and aggr in ("power", "power_sum") else set()
    want |= {"y"} if aggr in ("softmax_sum", "power_sum") else set()
    want |= {"msg_scale"} if mn and ls else set()
    assert learned == want
    if "y" in want and not ly:
        assert np.abs(pgr["aggregate.y"]).max() == 0.0  # frozen


@pytest.mark.parametrize("form", ["conv1x1", "pca_only"])
def test_genconv_encoder_forms_match_jax(form):
    case = ("softmax", True, False, False, False, False)
    (po, pdx, _, pgr), (jo, jdx, _, jgr) = _layer(
        case, False, encoder="conv1x1" if form == "conv1x1" else "linear",
        pca_only=form == "pca_only")
    _close(po, jo)
    _close(pdx, jdx)
    assert set(pgr) == set(jgr)
    for k in pgr:
        _close(pgr[k], jgr[k])


@pytest.mark.parametrize("kind", ["layer", "instance", "none", "batch"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_norm_eval_matches_jax(kind, bf16):
    rng = np.random.RandomState(5)
    x = (rng.randn(4, 30, 12) * 2 + 0.5).astype(np.float32)
    jdt = jnp.bfloat16 if bf16 else None
    xj = jnp.asarray(x, jdt or jnp.float32)
    jn = JNorm(kind, 12, dtype=jdt)
    v = jn.init(jax.random.PRNGKey(0), xj, False)
    flat = {k: np.asarray(a) for k, a in flax.traverse_util.flatten_dict(v, sep="/").items()}
    for k in flat:  # learned-looking scale / bias and batch statistics
        flat[k] = (rng.rand(*flat[k].shape) + 0.5).astype(np.float32)
    v = flax.traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(a)
                                           for k, a in flat.items()})
    jo = np.asarray(jax.jit(lambda v, a: jn.apply(v, a, False))(v, xj), np.float32)
    pn = Norm(kind, 12, dtype=torch.bfloat16 if bf16 else None)
    # the module as DeeperGCN's norm_0 (interop drops the inner flax names)
    load_flax_params(torch.nn.ModuleDict({"norm_0": pn}),
                     {"/".join(k.split("/")[:1] + ["norm_0"] + k.split("/")[1:]): a
                      for k, a in flat.items()})
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        torch.bfloat16 if bf16 else torch.float32)
    with torch.no_grad():
        po = pn.eval()(xt)
    assert str(po.dtype).split(".")[-1] == str(jo.dtype if not bf16 else "bfloat16") or bf16
    if bf16:
        # one cast of the same f32 value: equal
        assert po.dtype == (torch.bfloat16 if kind != "none" else xt.dtype)
        np.testing.assert_array_equal(po.float().numpy(), jo)
    else:
        _close(po.numpy(), jo)


def test_batch_norm_cannot_train_as_in_jax():
    x = np.ones((2, 5, 4), np.float32)
    jn = JNorm("batch", 4)
    v = jn.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    with pytest.raises(flax.errors.ModifyScopeVariableError):
        jn.apply(v, jnp.asarray(x), True)
    with pytest.raises(RuntimeError):
        Norm("batch", 4).train()(torch.from_numpy(x))


@pytest.mark.parametrize("norm", ["layer", "instance", "batch", None])
@pytest.mark.parametrize("last_lin", [True, False])
def test_mlp_norms_last_lin_match_jax(norm, last_lin):
    rng = np.random.RandomState(6)
    x = rng.randn(20, 3, 6).astype(np.float32)
    jm = JMLP([6, 12, 5], norm_type=norm, last_lin=last_lin)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    flat = {k: np.asarray(a) for k, a in flax.traverse_util.flatten_dict(v, sep="/").items()}
    jo = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, False))(v, jnp.asarray(x)))
    pm = MLP([6, 12, 5], norm_type=norm, last_lin=last_lin)
    load_flax_params(pm, flat)
    with torch.no_grad():
        _close(pm.eval()(torch.from_numpy(x)).numpy(), jo)


def test_interop_maps_every_deepergcn_param(tmp_path):
    """A flax DeeperGCN with every parameterised branch (node embedding,
    one-hot edge table, conv edge encoders, MsgNorm scale, learned t, the
    MSA readout, a batch norm) loads into the port with no key left over
    and no shape apart."""
    from multilevel_gnn_tpu.core.batch import Batch as JBatch
    from multilevel_gnn_tpu.core.batch import make_fold_context as j_make_ctx
    from multilevel_gnn_tpu.core.config import Config as JConfig
    from multilevel_gnn_tpu.models.deepergcn import DeeperGCN as JModel
    from multilevel_gnn_tpu_torch.core.config import Config

    jg, _ = _graphs()
    P, V = 8, 4
    kw = dict(model="deepergcn", hidden_channels=16, num_layers=2, node_embedding=True,
              node_embedding_dim=4, node_num=N, pathway_num=P, pathway_global_node=True,
              use_edge_attr=True, global_edge="onehot", conv_encode_edge=True,
              pathway_edge_num=V, pca_dim=2, use_age=True, num_layer_head=3,
              pathway_readout="MSA", gcn_aggr="softmax", learn_t=True, msg_norm=True,
              learn_msg_scale=True, norm="batch")
    jm = JModel(JConfig.from_dict(kw))
    jctx = j_make_ctx(jg, np.zeros(5, np.int64), np.zeros(5, np.int64), n_pathways=P)
    jb = JBatch(x=jnp.zeros((2, N, 3)), y=jnp.zeros((2, 2)), age=jnp.zeros(2),
                sample_mask=jnp.ones(2, bool), raw_data=jnp.zeros((2, P, 6)))
    v = jm.init(jax.random.PRNGKey(0), jb, jctx, False)  # the params' tree only
    flat = {k: np.asarray(a) for k, a in flax.traverse_util.flatten_dict(v, sep="/").items()}
    assert any(k.startswith("batch_stats/") for k in flat)
    model = get_model("deepergcn")(Config.from_dict(kw), device="cpu")
    load_flax_params(model, flat)  # raises on a key left over or a shape apart
    sd = state_dict_from_flax(flat)
    for name, t in sd.items():
        own = dict(model.named_parameters()).get(name, dict(model.named_buffers()).get(name))
        np.testing.assert_array_equal(own.detach().numpy(), t.numpy())
    assert model.readout_msa.MultiHeadDotProductAttention_0.query.weight.shape == (16, 8, 2)


def test_get_model_names_the_ported_models():
    assert get_model("deepergcn").__name__ == "DeeperGCN"
    assert get_model("multilevel_gnn").__name__ == "MultilevelGNN"
    assert get_model("pathcnn").__name__ == "PathCNN"
    with pytest.raises(NotImplementedError, match="multiomix"):
        get_model("multiomix")
