"""MiNet (OmicsNet, the Cox loss, the c-index and the sparse-coding
helpers) in the PyTorch port against the JAX package, on the CPU.

OmicsNet at small sizes (30 omics inputs, 12 genes, 5 pathways, hidden 6
and 4, B 8) with random connection masks; JAX's parameters and
batch_stats (moved off their init values) go through interop.py into the
port.  Limits: f32 outputs and gradients max|diff| / max(1, max|ref|) <=
1e-5; the float64 numpy helpers and the c-index equal.

- eval: the risk scores.
- training with the sub-network masks do_m1 / do_m2 handed in and drop
  rates (0.3, 0.2): the scores, the moved running statistics, and every
  parameter's gradient of the Cox loss.
- neg_partial_log_likelihood (tied times, censored rows) and
  concordance_index (tied predictions).
- dropout_mask, get_threshold, soft_threshold, get_sparse_weight,
  small_net_mask, get_best_sparsity, and sparse_func on the two interior
  kernels with one float64 loss callback shared by both packages.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.models import minet as jmn
from multilevel_gnn_tpu_torch.interop import load_flax_params, state_dict_from_flax
from multilevel_gnn_tpu_torch.models import minet as pmn
from torch_threads import few_threads  # noqa: F401  (autouse)

TOL = 1e-5
I, G, P, H, B = 30, 12, 5, (6, 4), 8


def rel_err(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(1.0, float(np.abs(ref).max())))


def flat(tree):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(0)
    d = dict(
        gm=(rng.rand(G, I) < 0.3).astype(np.float32),
        pm=(rng.rand(P, G) < 0.5).astype(np.float32),
        x=rng.randn(B, I).astype(np.float32),
        age=rng.rand(B).astype(np.float32),
        time=rng.randint(1, 6, B).astype(np.float32),
        event=(rng.rand(B) < 0.7).astype(np.float32),
        m1=jmn.dropout_mask(np.random.RandomState(1), P, 0.3),
        m2=jmn.dropout_mask(np.random.RandomState(2), H[0], 0.2),
    )
    net = jmn.OmicsNet(I, G, P, H)
    v = net.init(jax.random.PRNGKey(0), d["x"], d["age"], d["gm"], d["pm"])
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.rand(*a.shape).astype(np.float32) + 0.5), v["batch_stats"])
    v = {"params": v["params"], "batch_stats": stats}
    model = pmn.OmicsNet(I, G, P, H, device="cpu")
    load_flax_params(model, flat(v))
    return net, v, model, d


def _port_args(d):
    return [torch.as_tensor(d[k]) for k in ("x", "age", "gm", "pm")]


def test_eval_matches_jax(pair):
    net, v, model, d = pair
    jout = net.apply(v, d["x"], d["age"], d["gm"], d["pm"])
    model.eval()
    with torch.no_grad():
        pout = model(*_port_args(d))
    assert pout.shape == (B, 1)
    assert rel_err(pout.numpy(), jout) <= TOL


def test_training_with_dropout_masks_matches_jax(pair):
    net, v, model, d = pair
    rates = (0.3, 0.2)

    def loss(params):
        out, upd = net.apply({"params": params, "batch_stats": v["batch_stats"]}, d["x"],
                             d["age"], d["gm"], d["pm"], d["m1"], d["m2"], rates, True,
                             mutable=["batch_stats"])
        return jmn.neg_partial_log_likelihood(out, d["time"], d["event"]), (out, upd)

    (jl, (jout, jupd)), jg = jax.value_and_grad(loss, has_aux=True)(v["params"])
    model.train()
    for p in model.parameters():
        p.grad = None
    pout = model(*_port_args(d), torch.as_tensor(d["m1"]), torch.as_tensor(d["m2"]), rates)
    pl = pmn.neg_partial_log_likelihood(pout, torch.as_tensor(d["time"]),
                                        torch.as_tensor(d["event"]))
    pl.backward()
    assert rel_err(pout.detach().numpy(), jout) <= TOL
    assert abs(float(pl.detach()) - float(jl)) <= TOL * max(1.0, abs(float(jl)))
    moved = state_dict_from_flax(flat({"batch_stats": jupd["batch_stats"]}))
    buffers = dict(model.named_buffers())
    assert sorted(moved) == sorted(buffers)
    for name, want in moved.items():
        assert rel_err(buffers[name].numpy(), want.numpy()) <= TOL, name
    want = state_dict_from_flax(flat(jg))
    got = dict(model.named_parameters())
    assert sorted(want) == sorted(got)
    for name, g in want.items():
        assert rel_err(got[name].grad.numpy(), g.numpy()) <= TOL, name
    load_flax_params(model, flat(v))  # the running statistics as the fixture left them


def test_cox_loss_and_c_index_match_jax():
    rng = np.random.RandomState(5)
    pred = rng.randn(16).astype(np.float32)
    pred[3] = pred[7]  # a tied prediction
    time = rng.randint(1, 8, 16).astype(np.float32)  # tied times
    event = (rng.rand(16) < 0.6).astype(np.float32)
    jl = float(jmn.neg_partial_log_likelihood(pred, time, event))
    pl = float(pmn.neg_partial_log_likelihood(*(torch.as_tensor(a) for a in (pred, time, event))))
    assert abs(pl - jl) <= TOL * max(1.0, abs(jl))
    jc = float(jmn.concordance_index(pred, time, event))
    pc = float(pmn.concordance_index(*(torch.as_tensor(a) for a in (pred, time, event))))
    assert pc == jc and 0.0 < pc < 1.0


def test_sparse_coding_helpers_equal_jax():
    rng = np.random.RandomState(9)
    assert np.array_equal(pmn.dropout_mask(np.random.RandomState(4), 50, 0.3),
                          jmn.dropout_mask(np.random.RandomState(4), 50, 0.3))
    w = rng.randn(7, 5)
    mask = rng.rand(7, 5) < 0.6
    for s in (99.0, 50.0, 0.0):
        assert pmn.get_threshold(w, mask, s) == jmn.get_threshold(w, mask, s)
        assert np.array_equal(pmn.get_sparse_weight(w, mask, s), jmn.get_sparse_weight(w, mask, s))
    assert np.array_equal(pmn.soft_threshold(w, 0.4), jmn.soft_threshold(w, 0.4))
    m_in, m_out = rng.rand(7) < 0.5, rng.rand(5) < 0.5
    assert np.array_equal(pmn.small_net_mask(w, m_in, m_out), jmn.small_net_mask(w, m_in, m_out))
    levels, losses = [99.0, 74.25, 49.5, 24.75, 0.0], [0.9, 0.5, 0.45, 0.6, 0.7]
    assert pmn.get_best_sparsity(levels, losses) == jmn.get_best_sparsity(levels, losses)


def test_sparse_func_equals_jax(pair):
    net, v, model, d = pair
    rng = np.random.RandomState(3)
    m1 = np.ones(P, np.float32)
    m2 = (rng.rand(H[0]) < 0.7).astype(np.float32)
    m3 = (rng.rand(H[1]) < 0.7).astype(np.float32)
    target = {"pathway": rng.randn(P, H[0]), "hidden": rng.randn(H[0], H[1])}

    def score(kernels):  # float64, on (in, out) kernels
        return sum(float(((k.astype(np.float64) - target[n]) ** 2).sum()) for n, k in kernels.items())

    jout = jmn.sparse_func(v, lambda p: score({n: np.asarray(p["params"][n]["kernel"])
                                               for n in target}), m1, m2, m3)
    state = model.state_dict()
    pout = pmn.sparse_func(state, lambda st: score({n: st[f"{n}.weight"].numpy().T
                                                    for n in target}), m1, m2, m3)
    for n in target:
        np.testing.assert_array_equal(pout[f"{n}.weight"].numpy().T,
                                      np.asarray(jout["params"][n]["kernel"]))
        assert not np.array_equal(pout[f"{n}.weight"].numpy(), state[f"{n}.weight"].numpy())
