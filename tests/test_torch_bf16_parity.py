"""The bf16 trunk's rounding points against the JAX package's (XLA on the
CPU, under jax.jit as the package's steps run).

- F1 Linear: a bf16 Linear against flax.linen.Dense(dtype=bfloat16) on the
  same inputs and parameters: the product is rounded, then the bias added
  in bf16, so at most 8 of 4096 x 64 outputs differ, where the product's
  sum order moved it one bf16 ulp (the output then differs by that ulp
  and the bias add's rounding); an f32 Linear within 1e-6.
- F2 leaky_relu: bf16 outputs equal jax.nn.leaky_relu's on 2^16 normal
  draws (the slope is bf16(0.2)); the gradient at exactly 0 is 1, in f32
  and in bf16, as JAX's.
- F3, the bf16 backward:
  - the pathway contraction's cotangent for its bf16 input equals
    jax.vjp's (each PCA column's cotangent rounded to bf16, the columns
    added in bf16), at pca_dim 2 and 3;
  - the first SAGE / Edge layer's cotangent for its f32 input (the two
    bf16 cotangents of its uses added in f32, as XLA keeps the sum) equals
    jax.grad's through the same layer;
  - the bias gradient of a bf16 Linear: XLA sums it in bf16, 32 rows at a
    time (its tree-reduction rewrite; a loop of bf16 adds in that order
    gives JAX's bits), which torch's f32-accumulating sum does not
    reproduce; the port's equals the exact f32 sum rounded once to bf16,
    and test_torch_train.py holds the residue.
"""
import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.graph import Graph as JGraph
from multilevel_gnn_tpu.nn.conv import GraphConvLayer as JLayer
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu.ops.pathway import pathway_contract as j_contract
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.interop import flax_key_to_torch
from multilevel_gnn_tpu_torch.nn.basic import Linear, leaky_relu
from multilevel_gnn_tpu_torch.nn.conv import GraphConvLayer
from multilevel_gnn_tpu_torch.ops.pathway import pathway_contract
from torch_threads import few_threads  # noqa: F401  (autouse)

BF = jnp.bfloat16


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _ulp_bf16(v):
    """The bf16 spacing at |v|."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 1e-30)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_linear_rounds_as_flax_dense(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(4096, 72).astype(np.float32)
    W = (rng.randn(72, 64) * 0.1).astype(np.float32)
    b = (rng.randn(64) * 0.1).astype(np.float32)
    jdt = BF if dtype == "bfloat16" else jnp.float32
    dense = fnn.Dense(64, dtype=jdt)
    jy = np.asarray(jax.jit(dense.apply)(
        {"params": {"kernel": jnp.asarray(W), "bias": jnp.asarray(b)}},
        jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    lin = Linear(72, 64, dtype=getattr(torch, dtype))
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(W.T))
        lin.bias.copy_(torch.from_numpy(b))
    py = _np(lin(torch.from_numpy(x).to(getattr(torch, dtype))))
    if dtype == "float32":
        np.testing.assert_allclose(py, jy, rtol=0, atol=1e-6)
        return
    diff = py != jy
    assert diff.sum() <= 8, int(diff.sum())
    # one ulp of the product (the order of its sum), and the bias add's
    # rounding of the two products, which then differ, one ulp apart
    lim = _ulp_bf16((jy - b[None, :])[diff]) + _ulp_bf16(jy[diff])
    assert (np.abs(py - jy)[diff] <= lim).all()


def test_leaky_relu_matches_jax():
    x = np.random.RandomState(1).randn(1 << 16).astype(np.float32)
    xb = jnp.asarray(x).astype(BF)
    jy = np.asarray(jax.jit(lambda v: jax.nn.leaky_relu(v, 0.2))(xb).astype(jnp.float32))
    py = _np(leaky_relu(_t(xb, torch.bfloat16), 0.2))
    np.testing.assert_array_equal(py, jy)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, BF)):
        z = torch.zeros(3, dtype=tdt, requires_grad=True)
        leaky_relu(z, 0.2).sum().backward()
        jg = jax.grad(lambda v: jax.nn.leaky_relu(v, 0.2).sum())(jnp.zeros(3, jdt))
        np.testing.assert_array_equal(_np(z.grad), np.asarray(jg.astype(jnp.float32)))
        assert (_np(z.grad) == 1.0).all()


@pytest.mark.parametrize("K", [2, 3])
def test_pathway_contract_cotangent_matches_jax(K):
    rng = np.random.RandomState(K)
    B, G, C, S = 4, 300, 8, 18
    xg = jnp.asarray(rng.randn(B, G, C).astype(np.float32)).astype(BF)
    P = rng.randn(G, K).astype(np.float32)
    seg = np.sort(rng.randint(0, S, G))
    g = rng.randn(B, C, S, K).astype(np.float32)
    _, vjp = jax.vjp(lambda a: j_contract(a, jnp.asarray(P), jnp.asarray(seg), S), xg)
    jd = np.asarray(jax.jit(lambda c: vjp(c)[0])(jnp.asarray(g)).astype(jnp.float32))
    xt = _t(xg, torch.bfloat16).permute(1, 0, 2).contiguous().requires_grad_(True)
    out = pathway_contract(xt, torch.from_numpy(P), torch.from_numpy(seg), S)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_np(xt.grad).transpose(1, 0, 2), jd)


@pytest.mark.parametrize("conv", ["sage", "edge"])
def test_first_layer_input_cotangent_matches_jax(conv):
    rng = np.random.RandomState(4)
    n, e, B, D, H = 60, 240, 3, 8, 16
    ei = np.stack([rng.randint(0, n, e), rng.randint(0, n, e)])
    attr = rng.rand(e).astype(np.float32)
    jg_ = JGraph.from_edges(ei, attr, n).with_self_loops().with_sorted_meta()
    pg = Graph.from_edges(ei, attr, n).with_self_loops().with_sorted_meta("cpu")
    h = rng.randn(B, n, D).astype(np.float32)  # the trunk's f32 input
    G = rng.randn(B, n, H).astype(np.float32)
    layer = JLayer(D, H, conv=conv, act_type="leakyrelu", dtype=BF)
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    jspmm.set_spmm_dtype(BF)
    try:
        attr_j = jg_.edge_attr
        params = layer.init(jax.random.PRNGKey(0), jnp.asarray(h).astype(BF), jg_, attr_j)

        def f(x):
            out = layer.apply(params, x.astype(BF), jg_, attr_j)
            return (out.astype(jnp.float32) * jnp.asarray(G)).sum()

        jd = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(h)))
    finally:
        jspmm.set_backend(prev)
        jspmm.set_spmm_dtype(None)
    player = GraphConvLayer(D, H, conv=conv, act_type="leakyrelu", dtype=torch.bfloat16,
                            spmm_dtype=torch.bfloat16)
    flat = flax.traverse_util.flatten_dict(params, sep="/")
    sd = {}
    for k, v in flat.items():
        name = flax_key_to_torch(k)
        v = np.asarray(v)
        sd[name] = torch.from_numpy(v.T.copy() if v.ndim == 2 else v)
    player.load_state_dict(sd)
    x = torch.from_numpy(h).permute(1, 0, 2).requires_grad_(True)  # node-major
    out = player(x, pg, pg.edge_attr)
    (out.float() * torch.from_numpy(G).permute(1, 0, 2)).sum().backward()
    np.testing.assert_array_equal(_np(x.grad).transpose(1, 0, 2), jd)


def test_bias_gradient_is_the_f32_sum_rounded_once():
    rng = np.random.RandomState(5)
    g = jnp.asarray(rng.randn(4096, 64).astype(np.float32)).astype(BF)
    lin = Linear(72, 64, dtype=torch.bfloat16)
    x = torch.randn(4096, 72)
    lin(x).backward(_t(g, torch.bfloat16))
    exact = np.asarray(g.astype(jnp.float32)).sum(0)
    np.testing.assert_array_equal(_np(lin.bias.grad), _np(torch.from_numpy(exact).bfloat16()))
    # XLA's bf16 reduction (jax.vjp of the bias broadcast) lands elsewhere:
    # windows of 32 rows, each summed in bf16 with a rounding per add, then
    # the window sums likewise, which torch's sums do not do
    _, vjp = jax.vjp(lambda b: jnp.zeros((4096, 64), BF) + b[None], jnp.zeros(64, BF))
    jb = np.asarray(jax.jit(lambda c: vjp(c)[0])(g).astype(jnp.float32))
    assert np.abs(jb - exact).max() > np.abs(_np(lin.bias.grad) - exact).max()
    a = _t(g, torch.bfloat16)
    while a.shape[0] > 1:
        a = torch.cat([a, a.new_zeros(((-a.shape[0]) % 32, a.shape[1]))])
        a = a.reshape(-1, 32, a.shape[1])
        acc = a[:, 0]
        for i in range(1, 32):
            acc = acc + a[:, i]
        a = acc
    np.testing.assert_array_equal(_np(a[0]), jb)
