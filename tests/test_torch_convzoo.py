"""GCNConv, GATConv and GINConv of the PyTorch port against the JAX package's
GraphConvLayer on the 'pallas' backend (flat_segment_sum and windowed_exec
in interpret mode).  Parameters are initialised by flax and carried into
the port through interop.load_flax_params.

- GraphConvLayer(conv="gcn" / "gat" / "gin") on three graphs: self-looped
  with padding edges (K1 over csr / csc), with empty rows (no self loops),
  and self-looped with a window plan (K2 + the K1 residual): the output
  and the gradients to x and to every parameter, against jax.vjp under
  jit; f32 and the bf16 compute dtype (GAT stays f32 in both packages).
  With a string norm (Norm after GCN / GAT, the MLP's norm in GIN) and GIN
  with prelu.
- GCN's self loop enters twice, as in JAX (ROADMAP section 3): on a
  self-looped graph a node's row is summed once through its self-loop
  edge and once through the xw * dinv**2 term.
- The dispatcher raises only for the names JAX's raises for (gen).

Tolerances: f32 max|port - jax| <= 1e-5 * max(1, max|jax|).  bf16: against
JAX op by op (jax.disable_jit, each bf16 op rounded as written) the same
bound on the output and dx and 1e-3 of each parameter's largest gradient
(F4); against JAX under jit the output within 1e-5; the residues of
ROADMAP section 3 at twice their reading.
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
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.interop import load_flax_params, state_dict_from_flax
from multilevel_gnn_tpu_torch.nn.conv import GraphConvLayer
from torch_threads import few_threads  # noqa: F401  (autouse)

CIN, COUT, B = 6, 8, 3
GRAPHS = ["self_loops", "empty_rows", "windowed"]
# bf16 residues against JAX (ROADMAP section 3), twice their reading
BF16_GRAD_RESIDUE = {"gconv.nn.Linear_0.bias": 5.8e-2}  # F3 residue 1 (2.88e-2)
# the input cotangent: GAT's f32 sum rounded to bf16 (read 7.2e-5); the
# MLP's bf16 LayerNorm backward (R5, read 2.2e-4)
BF16_DX_RESIDUE = {"gat_norm": 1.5e-4, "gin_norm_prelu": 4.5e-4}
# the output under jit: GCN's tail (R4, read 2.51e-3) and the MLP's bf16
# LayerNorm (R4, read 6.10e-3)
BF16_JIT_RESIDUE = {"gcn": 5.1e-3, "gin_norm_prelu": 1.3e-2}


def _graph(kind):
    rng = np.random.RandomState({"self_loops": 3, "empty_rows": 4, "windowed": 5}[kind])
    n, e = 300, 1500
    if kind == "windowed":
        # local edges (|src - dst| < 40), so most fit the 128-row windows
        dst = rng.randint(0, n, e)
        src = np.clip(dst + rng.randint(-40, 40, e), 0, n - 1)
        ei = np.stack([src, dst])
    else:
        ei = np.stack([rng.randint(0, n, e), rng.randint(0, n - (12 if kind == "empty_rows" else 0), e)])
    attr = (rng.rand(e) + 0.1).astype(np.float32)
    jg, pg = JGraph.from_edges(ei, attr, n), Graph.from_edges(ei, attr, n)
    if kind != "empty_rows":
        jg, pg = jg.with_self_loops(), pg.with_self_loops()
    pad_to = jg.n_edges + 23
    jg, pg = jg.pad_edges_to(pad_to), pg.pad_edges_to(pad_to)
    if kind == "windowed":
        win = dict(perm_group=1, Wb=128, nwin=1)
        jg, pg = jg.with_window_meta(**win), pg.with_window_meta(**win)
        assert jg.winplan is not None and pg.winplan is not None
    return n, jg.with_sorted_meta(), pg.with_sorted_meta("cpu")


LAYERS = {
    "gcn": dict(conv="gcn"),
    "gat": dict(conv="gat", heads=4),
    "gin": dict(conv="gin"),
    "gcn_norm": dict(conv="gcn", norm="layer"),
    "gat_norm": dict(conv="gat", heads=2, norm="layer"),
    "gin_norm_prelu": dict(conv="gin", norm="layer", act_type="prelu"),
}
# bf16 (windowed graph): each conv, GAT with its norm, GIN's MLP with both;
# held to JAX op by op where XLA's jit rounds otherwise (R4), GAT (f32
# inside) to jit alone
BF16_LAYERS = ["gcn", "gin", "gat_norm", "gin_norm_prelu"]
BF16_EAGER = ["gcn", "gin", "gin_norm_prelu"]


@functools.lru_cache(maxsize=None)
def _layer_grads(name, kind, bf16, eager=False):
    """(out, dx, {param: grad}) of the JAX layer and of the port's, float64,
    in JAX's (B, N, C) layout.  eager: JAX op by op (jax.disable_jit), each
    bf16 op rounded as written; otherwise under jit, as the package's steps
    run."""
    n, jg, pg = _graph(kind)
    kw = {"act_type": "leakyrelu", **LAYERS[name]}
    rng = np.random.RandomState(5)
    x = rng.randn(B, n, CIN).astype(np.float32)
    dt = jnp.bfloat16 if bf16 else None
    jl = JLayer(CIN, COUT, dtype=dt, **kw)
    # the trunk hands each layer a bf16 x under the bf16 compute dtype
    xj = jnp.asarray(x).astype(dt) if bf16 else jnp.asarray(x)
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    jspmm.set_spmm_dtype(dt)
    try:
        params = jax.jit(lambda k, a: jl.init(k, a, jg, jg.edge_attr))(jax.random.PRNGKey(1), xj)
        # strong types, as after a first update: a fresh prelu slope is a
        # weak f32 (ROADMAP section 3, R3)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)), params)
        out_shape = jax.eval_shape(lambda p, a: jl.apply(p, a, jg, jg.edge_attr), params, xj)
        g = rng.randn(*out_shape.shape).astype(np.float32)

        def f(p, a, c):
            out, vjp = jax.vjp(lambda p, a: jl.apply(p, a, jg, jg.edge_attr), p, a)
            return (out,) + vjp(c.astype(out.dtype))

        if eager:
            with jax.disable_jit():
                out, jp_grad, jdx = f(params, xj, jnp.asarray(g))
        else:
            out, jp_grad, jdx = jax.jit(f)(params, xj, jnp.asarray(g))
    finally:
        jspmm.set_backend(prev)
        jspmm.set_spmm_dtype(None)
    flat = {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(params, sep="/").items()}
    jgrads = state_dict_from_flax(
        {k: np.asarray(v, np.float32) for k, v in
         flax.traverse_util.flatten_dict(jp_grad, sep="/").items()})
    tdt = torch.bfloat16 if bf16 else None
    layer = GraphConvLayer(CIN, COUT, dtype=tdt, spmm_dtype=tdt, **kw)
    load_flax_params(layer, flat)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2)))
    xt = (xt.to(tdt) if bf16 else xt).requires_grad_(True)
    po = layer(xt, pg, pg.edge_attr)
    assert str(po.dtype).split(".")[-1] == str(out.dtype), (po.dtype, out.dtype)
    assert layer.out_width == out.shape[-1]
    po.backward(torch.from_numpy(np.ascontiguousarray(g.transpose(1, 0, 2))).to(po.dtype))
    port = (po.detach().float().numpy().transpose(1, 0, 2).astype(np.float64),
            xt.grad.float().numpy().transpose(1, 0, 2).astype(np.float64),
            {k: p.grad.numpy().astype(np.float64) for k, p in layer.named_parameters()})
    ref = (np.asarray(out, np.float64), np.asarray(jdx, np.float64),
           {k: v.numpy().astype(np.float64) for k, v in jgrads.items()})
    return port, ref


def _rel(a, ref):
    return float(np.abs(a - ref).max() / max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("name", ["gcn", "gat", "gin"])
def test_conv_layer_f32_matches_jax(name, kind):
    (po, pdx, pgr), (jo, jdx, jgr) = _layer_grads(name, kind, False)
    assert _rel(po, jo) <= 1e-5 and _rel(pdx, jdx) <= 1e-5, (_rel(po, jo), _rel(pdx, jdx))
    assert set(pgr) == set(jgr)
    for k in pgr:
        assert _rel(pgr[k], jgr[k]) <= 1e-5, (k, _rel(pgr[k], jgr[k]))


def _check_bf16(name, eager):
    (po, pdx, pgr), (jo, jdx, jgr) = _layer_grads(name, "windowed", True, eager=eager)
    assert _rel(po, jo) <= 1e-5, _rel(po, jo)
    assert _rel(pdx, jdx) <= BF16_DX_RESIDUE.get(name, 1e-5), _rel(pdx, jdx)
    assert set(pgr) == set(jgr)
    for k in pgr:
        rel = np.abs(pgr[k] - jgr[k]).max() / max(np.abs(jgr[k]).max(), 1e-30)
        assert rel <= BF16_GRAD_RESIDUE.get(k, 1e-3), (k, rel)


@pytest.mark.parametrize("name", BF16_EAGER)
def test_conv_layer_bf16_matches_jax_eager(name):
    """Each bf16 op rounded as written, as JAX runs it op by op: equal but
    for the residues of ROADMAP section 3 (GIN's MLP bias gradient, F3
    residue 1; the MLP's bf16 LayerNorm backward, R5), held at twice their
    reading."""
    _check_bf16(name, eager=True)


@pytest.mark.parametrize("name", BF16_LAYERS)
def test_conv_layer_bf16_output_near_jax_jit(name):
    """Under jit XLA on the CPU drops bf16 round trips between elementwise
    ops (GCN's tail agg + xw * dinv**2, R4; a bf16 LayerNorm, R4): those
    outputs are held at twice their reading, the others at 1e-5; GAT, f32
    inside, is held in full (its input cotangent, an f32 sum rounded to
    bf16 in another order, at twice its reading)."""
    if name in BF16_EAGER:
        (po, _, _), (jo, _, _) = _layer_grads(name, "windowed", True)
        assert _rel(po, jo) <= BF16_JIT_RESIDUE.get(name, 1e-5), _rel(po, jo)
    else:
        _check_bf16(name, eager=False)


@pytest.mark.parametrize("name", ["gcn_norm", "gat_norm", "gin_norm_prelu"])
def test_conv_layer_norm_f32_matches_jax(name):
    (po, pdx, pgr), (jo, jdx, jgr) = _layer_grads(name, "self_loops", False)
    assert _rel(po, jo) <= 1e-5 and _rel(pdx, jdx) <= 1e-5
    assert set(pgr) == set(jgr) and any("Norm_0" in k for k in pgr)
    for k in pgr:
        assert _rel(pgr[k], jgr[k]) <= 1e-5, (k, _rel(pgr[k], jgr[k]))


def test_gcn_counts_the_self_loop_twice_as_jax_does():
    """JAX's GCNConv adds xw * dinv**2 for A + I and still sums the
    self-loop edges that MultilevelGNN's graph carries; the port does the
    same: on a graph of self loops only, out = 2 * xw / (deg + 1) = xw."""
    n = 5
    ei = np.zeros((2, 0), np.int64)
    jg = JGraph.from_edges(ei, np.zeros(0, np.float32), n).with_self_loops().with_sorted_meta()
    pg = Graph.from_edges(ei, np.zeros(0, np.float32), n).with_self_loops().with_sorted_meta("cpu")
    x = np.random.RandomState(0).randn(2, n, 3).astype(np.float32)
    jl = JLayer(3, 4, conv="gcn", act_type="none")
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    try:
        params = jl.init(jax.random.PRNGKey(0), jnp.asarray(x), jg, None)
        jout = np.asarray(jl.apply(params, jnp.asarray(x), jg, None))
    finally:
        jspmm.set_backend(prev)
    layer = GraphConvLayer(3, 4, conv="gcn", act_type="none")
    load_flax_params(layer, {k: np.asarray(v) for k, v in
                             flax.traverse_util.flatten_dict(params, sep="/").items()})
    pout = layer(torch.from_numpy(x.transpose(1, 0, 2).copy()), pg).detach().numpy()
    xw = x @ np.asarray(params["params"]["gconv"]["lin"]["kernel"])
    # each node: in-degree 1 (its loop), dinv**2 = 1/2, loop edge + self term
    np.testing.assert_allclose(jout, xw, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pout.transpose(1, 0, 2), jout, rtol=0, atol=1e-6)
    # without the double count the output would be xw / 2
    assert np.abs(jout - xw / 2).max() > 0.1 * np.abs(xw).max()


def test_gen_raises_as_in_jax():
    with pytest.raises(NotImplementedError):
        GraphConvLayer(4, 4, conv="gen")
    x = jnp.zeros((1, 3, 4))
    g = JGraph.from_edges(np.zeros((2, 0), np.int64), np.zeros(0, np.float32), 3).with_self_loops()
    with pytest.raises(NotImplementedError):
        JLayer(4, 4, conv="gen").init(jax.random.PRNGKey(0), x, g, None)


def test_interop_round_trip_of_the_new_params():
    """Every flax parameter of each new layer reaches the port (a missing or
    unknown key raises), and the round trip keeps the values."""
    n, jg, pg = _graph("self_loops")
    x = jnp.zeros((1, n, CIN))
    for name in ("gcn_norm", "gat_norm", "gin_norm_prelu"):
        kw = {"act_type": "leakyrelu", **LAYERS[name]}
        params = JLayer(CIN, COUT, **kw).init(jax.random.PRNGKey(2), x, jg, jg.edge_attr)
        flat = {k: np.asarray(v) for k, v in
                flax.traverse_util.flatten_dict(params, sep="/").items()}
        layer = GraphConvLayer(CIN, COUT, **kw)
        load_flax_params(layer, flat)
        sd = state_dict_from_flax(flat)
        for k, v in layer.named_parameters():
            np.testing.assert_array_equal(v.detach().numpy(), sd[k].numpy())
        key = next(iter(flat))
        with pytest.raises(KeyError):
            load_flax_params(layer, {k: v for k, v in flat.items() if k != key})
        with pytest.raises(KeyError):
            load_flax_params(layer, {**flat, "params/gconv/extra": np.zeros(1)})
