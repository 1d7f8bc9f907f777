"""The dense point-cloud blocks (nn/dense_blocks.py, the DeepGCN legacy) in
the PyTorch port against the JAX package, on the CPU.  The JAX package's
own tests/test_dense_blocks.py reads an absent reference tree, so this
file holds the port against the JAX package only.

A cloud x (2, 5, 17, 1), k 4: pairwise_distance, dense_knn_matrix and
dense_dilated (dilation 2) equal; batched_index_select equal.  BasicConv
(relu / leakyrelu; no norm, instance, batch in eval and in training with
its running statistics moved), MRConv2d, EdgeConv2d, GraphConv2d,
DynConv2d (with and without an edge index), PlainDynBlock2d,
ResDynBlock2d and DenseDynBlock2d: output and the VJP's input and
parameter cotangents at a seeded cotangent within 1e-5 relative to
max(1, max|ref|), JAX's parameters carried in through interop.py.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.nn import dense_blocks as jdb
from multilevel_gnn_tpu_torch.interop import load_flax_params, state_dict_from_flax
from multilevel_gnn_tpu_torch.nn import dense_blocks as pdb
from torch_threads import few_threads  # noqa: F401  (autouse)

TOL = 1e-5
B, C, N, K = 2, 5, 17, 4


def rel_err(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(1.0, float(np.abs(ref).max())))


def flat(tree):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def cloud(seed=0):
    return np.random.RandomState(seed).randn(B, C, N, 1).astype(np.float32)


def test_graph_helpers_equal_jax():
    x = cloud()
    pts = x[..., 0].transpose(0, 2, 1)
    np.testing.assert_allclose(pdb.pairwise_distance(torch.as_tensor(pts)).numpy(),
                               np.asarray(jdb.pairwise_distance(jnp.asarray(pts))), atol=1e-5)
    jei = np.asarray(jdb.dense_knn_matrix(jnp.asarray(x), K * 2))
    pei = pdb.dense_knn_matrix(torch.as_tensor(x), K * 2)
    np.testing.assert_array_equal(pei.numpy(), jei)
    np.testing.assert_array_equal(pdb.dense_dilated(pei, K, 2).numpy(),
                                  np.asarray(jdb.dense_dilated(jnp.asarray(jei), K, 2)))
    idx = np.random.RandomState(1).randint(0, N, (B, N, K))
    np.testing.assert_array_equal(
        pdb.batched_index_select(torch.as_tensor(x), torch.as_tensor(idx)).numpy(),
        np.asarray(jdb.batched_index_select(jnp.asarray(x), jnp.asarray(idx))))


def _edges(x):
    return np.asarray(jdb.dense_knn_matrix(jnp.asarray(x), K))


CASES = {
    "basic_relu": (lambda m: m.BasicConv([C, 7, 6]), False),
    "basic_leaky_instance": (lambda m: m.BasicConv([C, 6], "leakyrelu", "instance"), False),
    "basic_batch": (lambda m: m.BasicConv([C, 6, 4], "relu", "batch"), False),
    "mr": (lambda m: m.MRConv2d(C, 6), True),
    "edge": (lambda m: m.EdgeConv2d(C, 6, norm="batch"), True),
    "graph_mr": (lambda m: m.GraphConv2d(C, 6, "mr"), True),
    "dyn_given_edges": (lambda m: m.DynConv2d(C, 6, K), True),
    "dyn": (lambda m: m.DynConv2d(C, 6, K, dilation=2), False),
    "plain_dyn": (lambda m: m.PlainDynBlock2d(C, K, conv="mr"), False),
    "res_dyn": (lambda m: m.ResDynBlock2d(C, K, res_scale=0.5), False),
    "dense_dyn": (lambda m: m.DenseDynBlock2d(C, 3, K, norm="batch"), False),
}


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_jax(name, training):
    make, with_edges = CASES[name]
    x = cloud(len(name))
    jm, pm = make(jdb), make(pdb)
    args = (jnp.asarray(_edges(x)),) if with_edges else ()
    if not name.startswith("basic") and not with_edges:
        args = (None,)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), *args)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    if stats:  # running statistics off their init values
        rng = np.random.RandomState(2)
        stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.rand(*a.shape).astype(np.float32) + 0.5), stats)

    def fwd(p, xx):
        v = {"params": p, **({"batch_stats": stats} if stats else {})}
        if training and stats:
            return jm.apply(v, xx, *args, True, mutable=["batch_stats"])
        return jm.apply(v, xx, *args, training), None

    jout, vjp, jupd = jax.vjp(fwd, params, jnp.asarray(x), has_aux=True)
    cot = np.random.RandomState(3).randn(*jout.shape).astype(np.float32)
    jgp, jgx = vjp(jnp.asarray(cot))
    load_flax_params(pm, flat({"params": params, **({"batch_stats": stats} if stats else {})}))
    pm.train(training)
    xt = torch.tensor(x, requires_grad=True)
    pargs = (torch.tensor(np.array(args[0])),) if with_edges else ()
    out = pm(xt, *pargs)
    out.backward(torch.as_tensor(cot))
    assert rel_err(out.detach().numpy(), jout) <= TOL
    assert rel_err(xt.grad.numpy(), jgx) <= TOL
    want, got = state_dict_from_flax(flat(jgp)), dict(pm.named_parameters())
    assert sorted(want) == sorted(got)
    for n, g in want.items():
        assert rel_err(got[n].grad.numpy(), g.numpy()) <= TOL, n
    if training and stats:
        moved = state_dict_from_flax(flat({"batch_stats": jupd["batch_stats"]}))
        bufs = dict(pm.named_buffers())
        for n, v in moved.items():
            assert rel_err(bufs[n].numpy(), v.numpy()) <= TOL, n
