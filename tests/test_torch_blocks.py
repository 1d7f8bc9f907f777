"""kNN graphs and the dynamic-graph blocks in the PyTorch port against the
JAX package, on the CPU.

- knn_graph: senders and receivers equal to JAX's for dilation 1 and 2,
  unbatched (N, D) and batched (B, N, D); the stochastic branch (JAX draws
  from its own key, so by its contract): epsilon 0 gives the deterministic
  edges, epsilon 1 a k-subset of the k * dilation nearest, the same choice
  for every node, the same again from the same seed.
- dynamic_graph: the plans it builds on the device hold the same entries as
  Graph.with_sorted_meta's over the same edges.
- DynConv, ResDynBlock, DenseDynBlock, ResGraphBlock and DenseGraphBlock,
  x (40, 8), k 4, on a static graph (the JAX graph with its sorted plans,
  so both sides run the pallas form) and on the kNN graph of x (JAX:
  dynamic_graph, no plans, XLA's segment max; the port: the plans built on
  the device): output, and the VJP's input and parameter cotangents at a
  seeded cotangent, within 1e-5 relative to max(1, max|ref|).  EdgeConv's
  relu ties many messages at 0; the relu's gradient there is 0, so no tie
  rule of either side shows.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.graph import Graph as JGraph
from multilevel_gnn_tpu.nn import blocks as jblocks
from multilevel_gnn_tpu.nn.conv import dynamic_graph as j_dynamic_graph
from multilevel_gnn_tpu.ops import knn as jknn
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.interop import load_flax_params, state_dict_from_flax
from multilevel_gnn_tpu_torch.nn import blocks
from multilevel_gnn_tpu_torch.nn.conv import dynamic_graph
from multilevel_gnn_tpu_torch.ops import knn
from torch_threads import few_threads  # noqa: F401  (autouse)

TOL = 1e-5
N, C, K = 40, 8, 4


def rel_err(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(1.0, float(np.abs(ref).max())))


def flat(tree):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("batched", [False, True])
def test_knn_graph_equals_jax(dilation, batched):
    rng = np.random.RandomState(dilation)
    x = rng.randn(*((3, N, 5) if batched else (N, 5))).astype(np.float32)
    js, jr = jknn.knn_graph(jnp.asarray(x), K, dilation)
    ps, pr = knn.knn_graph(torch.as_tensor(x), K, dilation)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(knn.pairwise_sq_dists(torch.as_tensor(x)).numpy(),
                               np.asarray(jknn.pairwise_sq_dists(jnp.asarray(x))),
                               rtol=0, atol=1e-5)


def test_knn_stochastic_branch_by_its_contract():
    x = torch.as_tensor(np.random.RandomState(0).randn(N, 5).astype(np.float32))
    det = knn.knn_graph(x, K, 3)[0]
    g = torch.Generator().manual_seed(1)
    assert torch.equal(knn.knn_graph(x, K, 3, True, 0.0, g)[0], det)
    full = torch.topk(-knn.pairwise_sq_dists(x).fill_diagonal_(torch.finfo(torch.float32).max),
                      3 * K).indices
    s1 = knn.knn_graph(x, K, 3, True, 1.0, torch.Generator().manual_seed(2))[0].reshape(N, K)
    s2 = knn.knn_graph(x, K, 3, True, 1.0, torch.Generator().manual_seed(2))[0].reshape(N, K)
    assert torch.equal(s1, s2)
    pos = [[int((full[i] == j).nonzero()) for j in s1[i]] for i in range(N)]
    assert all(p == pos[0] for p in pos) and len(set(pos[0])) == K


def test_dynamic_graph_plans_hold_the_sorted_meta_entries():
    x = torch.as_tensor(np.random.RandomState(4).randn(N, 5).astype(np.float32))
    s, r = knn.knn_graph(x, K)
    dg = dynamic_graph(s, r, N)
    sg = Graph.from_edges(np.stack([s.numpy(), r.numpy()]), None, N).with_sorted_meta("cpu")
    for name in ("csr", "csc", "src_gather", "dst_gather"):
        a, b = getattr(dg, name), getattr(sg, name)
        assert torch.equal(a.rowptr, b.rowptr), name
        for f in ("col", "eid", "row"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)
    assert torch.equal(dg.in_degree(), sg.in_degree())
    assert torch.allclose(dg.gcn_coef, sg.gcn_coef) and torch.allclose(dg.gcn_self, sg.gcn_self)


def _static_graph():
    rng = np.random.RandomState(11)
    ei = np.stack([rng.randint(0, N, 160), rng.randint(0, N, 160)]).astype(np.int32)
    return (JGraph.from_edges(ei, None, N).with_sorted_meta(),
            Graph.from_edges(ei, None, N).with_sorted_meta("cpu"))


BLOCKS = {
    "DynConv": (lambda: jblocks.DynConv(C, C, K, conv="edge"),
                lambda: blocks.DynConv(C, C, K, conv="edge")),
    "DynConv_mr": (lambda: jblocks.DynConv(C, 6, K, dilation=2, conv="mr", act_type="leakyrelu"),
                   lambda: blocks.DynConv(C, 6, K, dilation=2, conv="mr", act_type="leakyrelu")),
    "ResDynBlock": (lambda: jblocks.ResDynBlock(C, K, res_scale=0.5),
                    lambda: blocks.ResDynBlock(C, K, res_scale=0.5)),
    "DenseDynBlock": (lambda: jblocks.DenseDynBlock(C, 6, K),
                      lambda: blocks.DenseDynBlock(C, 6, K)),
    "ResGraphBlock": (lambda: jblocks.ResGraphBlock(C, res_scale=0.5),
                      lambda: blocks.ResGraphBlock(C, res_scale=0.5)),
    "DenseGraphBlock": (lambda: jblocks.DenseGraphBlock(C, 6, conv="mr"),
                        lambda: blocks.DenseGraphBlock(C, 6, conv="mr")),
}


@pytest.mark.parametrize("graph", ["static", "dynamic"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name, graph):
    rng = np.random.RandomState(len(name))
    x = rng.randn(N, C).astype(np.float32)
    jm, pm = BLOCKS[name][0](), BLOCKS[name][1]()
    needs_graph = "Graph" in name
    jg = pg = None
    if graph == "static":
        jg, pg = _static_graph()
    elif needs_graph:  # the kNN graph of x, built by each package
        s, r = jknn.knn_graph(jnp.asarray(x), K)
        jg = j_dynamic_graph(s, r, N)
        ps, pr = knn.knn_graph(torch.as_tensor(x), K)
        pg = dynamic_graph(ps, pr, N)
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    try:
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jg)
        jout, vjp = jax.vjp(lambda p, xx: jm.apply(p, xx, jg), params, jnp.asarray(x))
        cot = rng.randn(*jout.shape).astype(np.float32)
        jgp, jgx = vjp(jnp.asarray(cot))
    finally:
        jspmm.set_backend(prev)
    load_flax_params(pm, flat(params))
    xt = torch.tensor(x, requires_grad=True)
    out = pm(xt, pg)
    out.backward(torch.as_tensor(cot))
    assert rel_err(out.detach().numpy(), jout) <= TOL
    assert rel_err(xt.grad.numpy(), jgx) <= TOL
    want, got = state_dict_from_flax(flat(jgp)), dict(pm.named_parameters())
    assert sorted(want) == sorted(got)
    for n, g in want.items():
        assert rel_err(got[n].grad.numpy(), g.numpy()) <= TOL, n
