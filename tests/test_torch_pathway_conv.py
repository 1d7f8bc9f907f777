"""PathwayConv and Cohort.multiomix_vnode_data in the PyTorch port against
the JAX package, on the CPU (MultiOmixGCN's layer and data; the model is in
test_torch_multiomix.py, whose setup this file shares).  JAX runs on its
'pallas' backend (Pallas in interpret mode); its parameters go through
interop.py into the port, which runs its plain versions on the CPU.
Limit: max|diff| / max(1, max|ref|) <= 1e-5.

- PathwayConv alone, on 40 genes linked to 6 pathway nodes with (E, 2)
  attrs, x (3, 46, 8): max, softmax with learned t, without edge attrs
  (and then without msg_encoder, as flax builds none), without mask; the
  output and the VJP's input and parameter cotangents.
- multiomix_vnode_data: every graph's edges and attrs, mask and attrs
  equal to JAX's, also with one omics left without columns (its empty
  graph padded to 128 edge slots, no attrs, a zero mask).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.graph import Graph as JGraph
from multilevel_gnn_tpu.nn.conv import PathwayConv as JPathwayConv
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.interop import load_flax_params, state_dict_from_flax
from multilevel_gnn_tpu_torch.nn.conv import PathwayConv
from test_torch_multiomix import TOL, flat, pallas, rel_err, setup
from torch_threads import few_threads  # noqa: F401  (autouse)


def _pathway_graph():
    """Genes 0..39 to pathway nodes 40..45, 9 members each, (E, 2) attrs."""
    rng = np.random.RandomState(3)
    edges = [[g, 40 + p] for p in range(6) for g in sorted(rng.choice(40, 9, replace=False))]
    ei = np.array(edges, np.int32).T
    ea = rng.randn(ei.shape[1], 2).astype(np.float32)
    return ei, ea, 46


PWC_CASES = [dict(aggr="max"), dict(aggr="softmax", learn_t=True),
             dict(aggr="softmax", attrs=False), dict(aggr="max", mask=False)]


@pytest.mark.parametrize("case", PWC_CASES, ids=["max", "softmax_learn_t", "no_edge_attrs",
                                                  "no_mask"])
def test_pathway_conv_matches_jax(case):
    ei, ea, N = _pathway_graph()
    H, Bn = 8, 3
    attrs, use_mask = case.get("attrs", True), case.get("mask", True)
    jg = JGraph.from_edges(ei, ea, N).with_sorted_meta()
    pg = Graph.from_edges(ei, ea, N).with_sorted_meta("cpu")
    rng = np.random.RandomState(7)
    x = rng.randn(Bn, N, H).astype(np.float32)
    cot = rng.randn(Bn, N, H).astype(np.float32)
    mask = np.zeros((N, 1), np.float32)
    mask[40:] = 1.0
    jm = JPathwayConv(H, H, edge_feat_dim=2, aggr=case["aggr"], learn_t=case.get("learn_t", False),
                      norm_type="layer")
    e_j = jnp.asarray(ea) if attrs else None
    m_j = jnp.asarray(mask) if use_mask else None

    def run():
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jg, e_j, m_j)
        out, vjp = jax.vjp(lambda p, xx: jm.apply(p, xx, jg, e_j, m_j), params, jnp.asarray(x))
        return params, out, vjp(jnp.asarray(cot))

    params, jout, (jgp, jgx) = pallas(run)
    pm = PathwayConv(H, H, edge_feat_dim=2 if attrs else None, aggr=case["aggr"],
                     learn_t=case.get("learn_t", False), norm_type="layer")
    load_flax_params(pm, flat(params))
    xt = torch.tensor(x.transpose(1, 0, 2), requires_grad=True)
    out = pm(xt, pg, pg.edge_attr if attrs else None,
             torch.as_tensor(mask) if use_mask else None)
    out.backward(torch.as_tensor(cot.transpose(1, 0, 2)))
    assert rel_err(out.detach().numpy().transpose(1, 0, 2), jout) <= TOL
    assert rel_err(xt.grad.numpy().transpose(1, 0, 2), jgx) <= TOL
    want = state_dict_from_flax(flat(jgp))
    got = dict(pm.named_parameters())
    assert sorted(want) == sorted(got)
    for name, g in want.items():
        assert rel_err(got[name].grad.numpy(), g.numpy()) <= TOL, name


# -------------------------------------------------------------- vnode data
def _check_vnode_equal(jdata, pdata):
    for jd, pd in zip(jdata[:2], pdata[:2]):
        assert sorted(jd) == sorted(pd) == ["cnv", "mrna", "mt"]
    for k in ("mrna", "cnv", "mt"):
        jg, pg = jdata[0][k], pdata[0][k]
        assert (pg.n_nodes, pg.n_edges) == (jg.n_nodes, jg.n_edges)
        for name in ("senders", "receivers", "edge_mask"):
            np.testing.assert_array_equal(getattr(pg, name).numpy(), np.asarray(getattr(jg, name)))
        assert (pg.edge_attr is None) == (jg.edge_attr is None)
        if jg.edge_attr is not None:
            np.testing.assert_array_equal(pg.edge_attr.numpy(), np.asarray(jg.edge_attr))
        np.testing.assert_array_equal(pdata[1][k].numpy(), np.asarray(jdata[1][k]))
        np.testing.assert_array_equal(pdata[2][k].numpy(), np.asarray(jdata[2][k]))


def test_vnode_data_equals_jax():
    s = setup()
    _check_vnode_equal(s["jdata"], s["pdata"])
    assert all(g.n_edges > 0 for g in s["pdata"][0].values())


def test_vnode_data_with_an_empty_omics_equals_jax(monkeypatch):
    s = setup()
    for c in (s["jc"], s["pc"]):
        real = c._pathway_columns
        monkeypatch.setattr(c, "_pathway_columns", lambda pw, om, real=real: (
            [] if om == "cnv" else real(pw, om)))
    jdata = s["jc"].multiomix_vnode_data(s["jf"])
    pdata = s["pc"].multiomix_vnode_data(s["pf"], device="cpu")
    _check_vnode_equal(jdata, pdata)
    g = pdata[0]["cnv"]
    assert g.n_edges == 0 and g.num_padded_edges == 128 and g.edge_attr is None
    assert float(pdata[1]["cnv"].sum()) == 0.0
