"""DeeperGCN's GENConv in the bf16 trunk, the port against the JAX
package's bf16 (the 'pallas' backend, Pallas in interpret mode), on the
cases and graph of test_torch_deepergcn.py.

The port rounds each bf16 op as the model writes it, as JAX does op by op
(jax.disable_jit, 'eager').  Its backward is held to JAX eager's:

- GenAggregate alone, for each case, on the same bf16 messages and
  cotangent: the message cotangent equal, the f32 output and learnables
  within twice their reading (f32 sums in another order: K1's plain
  version adds in edge order, the Pallas kernel in interpret mode through
  XLA's dot).
- MsgNorm alone: the input cotangent equal (its square root takes JAX's
  backward, g * (0.5 / sqrt)).
- The whole layer with JAX's aggregate output handed to the port (the
  sums above, rounded to bf16 at x + m, flip a bf16 value now and then, and
  the LayerNorm and relu after it amplify the flip; ROADMAP section 3,
  R1): output and input cotangent equal; the edge-feature cotangent and the
  parameter gradients within twice their reading, where XLA on the CPU sums
  a bf16 reduction (the broadcast of e over the batch, a bias over the
  rows) in bf16, one rounding per add (test_bf16_broadcast_transpose_
  sums_in_bf16), and the port in f32, rounded once.
- JAX's params made strong first: a learned t is created weakly typed
  (jnp.full of a Python float), so until the first optimizer update JAX
  multiplies a bf16 message by it in bf16; the port, as JAX after that
  update, in f32 (R3, test_jax_learned_t_is_weak_until_first_update).

Against JAX under jit, where XLA computes a bf16 elementwise op in f32 and
drops the bf16 round trip between two such ops (test_dense_layer_norm_
residue), the output only, within twice the residue's reading.
"""
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from multilevel_gnn_tpu.nn.basic import MLP as JMLP
from multilevel_gnn_tpu.nn.conv import GENConv as JGENConv
from multilevel_gnn_tpu.nn.conv import GenAggregate as JGenAggregate
from multilevel_gnn_tpu.nn.conv import MsgNorm as JMsgNorm
from multilevel_gnn_tpu_torch.interop import load_flax_params, state_dict_from_flax
from multilevel_gnn_tpu_torch.nn.basic import MLP, layer_norm
from multilevel_gnn_tpu_torch.nn.conv import GENConv, GenAggregate, MsgNorm

from test_torch_deepergcn import (B, BF16_LAYER_RESIDUE, C, E, LAYER_CASES, LAYER_IDS, N,
                                  PAD, _close, _graphs, _layer, _nm, _pallas)
from torch_threads import few_threads  # noqa: F401  (autouse)

# max|diff| / max(1, max|ref|) against JAX eager, twice the worst reading of
# tests/torch_deepergcn_report.py: GenAggregate's f32 output 2.39e-7 and
# learnables 3.16e-7 (sum order); the whole layer with JAX's aggregate
# output: the edge-feature cotangent 3.91e-3 and edge_encoder's weight
# gradient 5.38e-3 (e's batch reduction), the Linear biases' gradients
# 1.92e-2 (their row reduction), every other gradient 8.98e-5
EAGER_RESIDUE = {"agg": 4.8e-7, "agg_param": 6.4e-7, "de": 7.9e-3, "edge_weight": 1.1e-2,
                 "bias": 3.9e-2, "param": 1.8e-4}


def _residue(name):
    if name == "edge_encoder.weight":
        return EAGER_RESIDUE["edge_weight"]
    if name.endswith(".bias") and "Norm" not in name:
        return EAGER_RESIDUE["bias"]
    return EAGER_RESIDUE["param"]


def _strong(tree):
    """The arrays as numpy gives them back: no weak type (an optimizer
    update or a checkpoint load leaves a parameter so)."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)), tree)


def _f64(a):
    return np.asarray(np.asarray(a, np.float32), np.float64)


def _inputs():
    rng = np.random.RandomState(3)
    x = rng.randn(B, N, C).astype(np.float32)
    e = rng.randn(E + PAD, C).astype(np.float32)
    g = rng.randn(B, N, C).astype(np.float32)
    return x, e, g


def _kw(case):
    aggr, lt, lp, ly, mn, ls = case
    return dict(aggr=aggr, t=0.7, learn_t=lt, p=1.3, learn_p=lp, y=0.2, learn_y=ly,
                msg_norm=mn, learn_msg_scale=ls, encode_edge=True, edge_feat_dim=C,
                norm_type="layer", mlp_layers=2)


@functools.lru_cache(maxsize=None)
def eager_layer(case, same_m: bool = True):
    """bf16 GENConv on both sides from the same strong params, JAX op by op:
    (port, jax) each (out, dx, de, {param: grad}) in the JAX layout,
    float64.  same_m: the port's aggregate output replaced by JAX's."""
    jg, pg = _graphs()
    x, e, g = _inputs()
    jl = JGENConv(C, C, dtype=jnp.bfloat16, **_kw(case))

    def run():
        params = _strong(jax.jit(lambda k: jl.init(k, jnp.asarray(x), jg, jnp.asarray(e)))(
            jax.random.PRNGKey(4)))

        def f(p, a, ea):
            out, st = jl.apply(p, a, jg, ea, capture_intermediates=True)
            return out, st["intermediates"]["aggregate"]["__call__"][0]

        with jax.disable_jit():
            out, vjp, m = jax.vjp(f, params, jnp.asarray(x), jnp.asarray(e), has_aux=True)
            return params, out, m, vjp(jnp.asarray(g).astype(out.dtype))

    params, jo, jm, (jp, jdx, jde) = _pallas(run)
    layer = GENConv(C, C, dtype=torch.bfloat16, **_kw(case))
    load_flax_params(layer, {k: np.asarray(v) for k, v in
                             flax.traverse_util.flatten_dict(params, sep="/").items()})
    if same_m:
        m_ref = torch.from_numpy(_nm(np.asarray(jm, np.float32)))

        def take_jax_m(mod, inputs, out):
            # b - a is exact for a, b this close, so a + (b - a) is b
            out = out + (m_ref - out).detach()
            assert torch.equal(out.detach(), m_ref)
            return out

        layer.aggregate.register_forward_hook(take_jax_m)
    xt = torch.from_numpy(_nm(x)).requires_grad_(True)
    et = torch.from_numpy(e).requires_grad_(True)
    po = layer(xt, pg, et)
    po.backward(torch.from_numpy(_nm(g)).to(po.dtype))
    jgr = state_dict_from_flax({k: np.asarray(v, np.float32) for k, v in
                                flax.traverse_util.flatten_dict(jp, sep="/").items()})
    port = (_f64(_nm(po.detach().float().numpy())), _f64(_nm(xt.grad.numpy())),
            _f64(et.grad.numpy()),
            {k: _f64(p.grad.numpy()) if p.grad is not None else np.zeros(p.shape)
             for k, p in layer.named_parameters()})
    ref = (_f64(jo), _f64(jdx), _f64(jde), {k: _f64(v.numpy()) for k, v in jgr.items()})
    return port, ref


@pytest.mark.parametrize("case", LAYER_CASES, ids=LAYER_IDS)
def test_genconv_bf16_within_residue_of_jax_bf16(case):
    """The output against JAX's bf16 under jit (R1)."""
    port, ref = _layer(case, True)
    _close(port[0], ref[0], BF16_LAYER_RESIDUE["out"])


@pytest.mark.parametrize("case", LAYER_CASES, ids=LAYER_IDS)
def test_genconv_bf16_backward_matches_jax_eager(case):
    port, ref = eager_layer(case)
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[1], ref[1])
    _close(port[2], ref[2], EAGER_RESIDUE["de"])
    assert set(port[3]) == set(ref[3])
    for k in port[3]:
        _close(port[3][k], ref[3][k], _residue(k))


@pytest.mark.parametrize("case", LAYER_CASES, ids=LAYER_IDS)
def test_genaggregate_bf16_matches_jax_eager(case):
    """GenAggregate on the same bf16 messages (relu(.) + eps, with a tie at
    eps wherever relu cut) and the same f32 cotangent, JAX op by op."""
    aggr, lt, lp, ly, _, _ = case
    jg, pg = _graphs()
    rng = np.random.RandomState(11)
    msg = jnp.asarray(np.maximum(rng.randn(B, E + PAD, C), 0) + 1e-7, jnp.bfloat16)
    g = rng.randn(B, N, C).astype(np.float32)
    ja = JGenAggregate(aggr, 0.7, lt, 1.3, lp, 0.2, ly)

    def run():
        v = _strong(ja.init(jax.random.PRNGKey(0), msg, jg))
        with jax.disable_jit():
            out, vjp = jax.vjp(lambda v, m: ja.apply(v, m, jg), v, msg)
            return v, out, vjp(jnp.asarray(g))

    v, jo, (jv, jd) = _pallas(run)
    pa = GenAggregate(aggr, 0.7, lt, 1.3, lp, 0.2, ly)
    load_flax_params(torch.nn.ModuleDict({"aggregate": pa}), {
        "params/aggregate/" + k.split("/")[-1]: np.asarray(a)
        for k, a in flax.traverse_util.flatten_dict(v, sep="/").items()})
    mt = torch.from_numpy(_nm(np.array(msg.astype(jnp.float32)))).to(torch.bfloat16)
    mt.requires_grad_(True)
    po = pa(mt, pg)
    po.backward(torch.from_numpy(_nm(g)))
    _close(_nm(po.detach().numpy()), jo, EAGER_RESIDUE["agg"])
    np.testing.assert_array_equal(_nm(mt.grad.float().numpy()), np.asarray(jd, np.float32))
    jgr = {k.split("/")[-1]: np.asarray(a) for k, a in
           flax.traverse_util.flatten_dict(jv, sep="/").items()}
    assert {k for k, _ in pa.named_parameters()} == set(jgr)
    for k, p in pa.named_parameters():
        grad = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        _close(grad, jgr[k], EAGER_RESIDUE["agg_param"])


@pytest.mark.parametrize("learn_scale", [False, True], ids=["fixed", "scale"])
def test_msgnorm_bf16_backward_matches_jax_eager(learn_scale):
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(N, B, C) * 3, jnp.bfloat16)
    m = jnp.asarray(rng.randn(N, B, C), jnp.float32)
    g = jnp.asarray(rng.randn(N, B, C), jnp.float32)
    jm = JMsgNorm(learn_scale)
    v = jm.init(jax.random.PRNGKey(0), x, m)
    with jax.disable_jit():
        jo, vjp = jax.vjp(lambda v, x, m: jm.apply(v, x, m), v, x, m)
        jv, jdx, jdm = vjp(g)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    xt.requires_grad_(True)
    mt = torch.from_numpy(np.array(m)).requires_grad_(True)
    pm = MsgNorm(learn_scale)
    po = pm(xt, mt)
    po.backward(torch.from_numpy(np.array(g)))
    _close(po.detach().numpy(), jo)
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(jdx, np.float32))
    _close(mt.grad.numpy(), jdm)
    if learn_scale:
        _close(pm.msg_scale.grad.numpy(), jv["params"]["msg_scale"])


def test_jax_learned_t_is_weak_until_first_update():
    """R3: JAX creates t with jnp.full of a Python float, a weakly typed
    f32, so a bf16 message times it stays bf16 until an optimizer update
    makes t strong; the port multiplies in f32 throughout, as JAX does
    from then on."""
    jg, _ = _graphs()
    msg = jnp.ones((B, E + PAD, C), jnp.bfloat16)
    ja = JGenAggregate("softmax", 0.7, True)
    t = ja.init(jax.random.PRNGKey(0), msg, jg)["params"]["t"]
    assert t.dtype == jnp.float32 and t.weak_type
    assert (msg * t).dtype == jnp.bfloat16
    opt = optax.adam(1e-3)
    upd, _ = opt.update(jnp.ones_like(t), opt.init(t), t)
    t1 = optax.apply_updates(t, upd)
    assert not t1.weak_type and (msg * t1).dtype == jnp.float32
    pa = GenAggregate("softmax", 0.7, True)
    assert (torch.ones(2, dtype=torch.bfloat16) * pa.t).dtype == torch.float32


@pytest.mark.parametrize("rows", [3, 32])
def test_bf16_broadcast_transpose_sums_in_bf16(rows):
    """The cotangent of a bf16 e broadcast over rows rows: JAX (eager and
    jit alike) adds them one by one in bf16, rounding each sum; the port's
    autograd sums in f32 and rounds once."""
    rng = np.random.RandomState(0)
    g = jnp.asarray(rng.randn(rows, E, C), jnp.bfloat16)
    zero = jnp.zeros((rows, E, C), jnp.bfloat16)
    with jax.disable_jit():
        de = jax.vjp(lambda e: zero + e, jnp.zeros((E, C), jnp.bfloat16))[1](g)[0]
    gt = torch.from_numpy(np.array(g.astype(jnp.float32))).to(torch.bfloat16)
    seq = gt[0]
    for i in range(1, rows):
        seq = seq + gt[i]
    np.testing.assert_array_equal(np.asarray(de, np.float32), seq.float().numpy())
    e = torch.zeros(E, C, dtype=torch.bfloat16, requires_grad=True)
    (torch.zeros(rows, E, C, dtype=torch.bfloat16) + e).backward(gt)
    once = gt.float().sum(0).bfloat16()
    np.testing.assert_array_equal(e.grad.float().numpy(), once.float().numpy())
    assert (e.grad != seq).any()


EAGER_EQUAL = [LAYER_CASES[i] for i in (1, 3, 7, 9, 11)]


@pytest.mark.parametrize("case", EAGER_EQUAL, ids=[LAYER_IDS[i] for i in (1, 3, 7, 9, 11)])
def test_genconv_bf16_forward_equals_jax_eager(case):
    """Op by op, JAX rounds each bf16 result as the model writes it, as the
    port does: where no f32 sum order flips a rounding of the aggregate,
    the forward outputs are equal without handing it over."""
    port, ref = eager_layer(case, same_m=False)
    np.testing.assert_array_equal(port[0], ref[0])


def test_dense_layer_norm_residue():
    """XLA on the CPU under jit: a bf16 Dense rounds its product to bf16,
    adds the bias in f32 and hands the unrounded sum to the next
    LayerNorm; the port's Linear (product and bias add each rounded, as
    flax writes them) differs by a bf16 ulp on some outputs, and the f32
    bias add gives JAX's bits exactly."""
    rng = np.random.RandomState(0)
    x = rng.randn(68, 4, 16).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jm = JMLP([16, 32, 16], norm_type="layer", last_lin=True, dtype=jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(0), xb)
    flat = {k: np.asarray(a) for k, a in flax.traverse_util.flatten_dict(v, sep="/").items()}
    for k in flat:
        if "Norm" in k:
            flat[k] = rng.randn(*flat[k].shape).astype(np.float32)
    v = flax.traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(a)
                                           for k, a in flat.items()})
    jo = np.asarray(jax.jit(jm.apply)(v, xb), np.float32)
    pm = MLP([16, 32, 16], norm_type="layer", last_lin=True, dtype=torch.bfloat16)
    load_flax_params(pm, flat)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        port = pm(xt).float().numpy()
        L0, n0 = pm.Linear_0, pm.Norm_0
        h = F.linear(xt, L0.weight.bfloat16()).float() + L0.bias.bfloat16().float()
        y = torch.relu(layer_norm(h, n0.scale, n0.bias, 1e-5, torch.bfloat16))
        xla = pm.Linear_1(y).float().numpy()
    np.testing.assert_array_equal(xla, jo)
    assert (port != jo).any()
    _close(port, jo, BF16_LAYER_RESIDUE["out"])
