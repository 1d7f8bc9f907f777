"""The pathway contraction's PW ops (ops/kernels/pathway.py) on the CPU.

The plain versions, which a CPU tensor takes, and ``pathway_contract``
(ops/pathway.py, the Function the models call) against the dense form
written out here: the slot one-hot weighted by each PCA column, (K*S, G) @
x2.float(), whose backward rounds each column's product for x2 to x2's
dtype and adds the columns in that dtype, the last first, and whose P
gradient is the f32 product g @ x2.T reduced through the one-hot (the
arithmetic of ``_Contract`` and of autograd through ``W = M * P.T``).

Cases: K 1, 2, 3; C 1 (PathCNN's F = B) and 32; x in bf16 and f32; slot
ids sorted, unsorted, and with ids of no slot (-1 and S); every case has
empty slots, single-row slots and a slot of more than CHUNK rows (the
forward's partial sums).  ``out`` and dP are held to 1e-5 x max(1,
max|dense|) (f32 sums in another order), dx to equality.
"""
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu_torch.ops.kernels import pathway as pw
from multilevel_gnn_tpu_torch.ops.pathway import pathway_contract
from torch_threads import few_threads  # noqa: F401  (autouse)

TOL = 1e-5
S = 16
B = 4


def _ids(rng, kind):
    """Slot ids of G rows: slot 1 longer than a chunk, slots 2 and 5 of one
    row, slots 0, 7 and S - 1 empty."""
    long = np.full(pw.CHUNK + 37, 1)
    rest = rng.choice([3, 4, 6, 8, 9, 10, 11, 12, 13, 14], 250)
    ids = np.concatenate([long, [2, 5], rest])
    if kind == "sorted":
        return np.sort(ids)
    rng.shuffle(ids)
    if kind == "no_slot":
        ids[rng.choice(len(ids), 20, replace=False)] = rng.choice([-1, S], 20)
    return ids


def _dense(x2, p, ids, g):
    """The dense form's output, dx and dP at cotangent g."""
    K, G = p.shape[1], x2.shape[0]
    M = (torch.as_tensor(ids)[None, :] == torch.arange(S)[:, None]).float()
    W = M[None, :, :] * p.T[:, None, :]  # (K, S, G)
    out = W.reshape(K * S, G) @ x2.float()
    gk = g.reshape(K, S, -1)
    dx = None
    for k in reversed(range(K)):
        d = (W[k].T @ gk[k]).to(x2.dtype)
        dx = d if dx is None else dx + d
    dW = (g @ x2.float().T).reshape(K, S, G)
    dp = (dW * M[None]).sum(1).T
    return out, dx, dp


def _close(got, ref):
    err = float((got - ref).abs().max())
    assert err <= TOL * max(1.0, float(ref.abs().max())), err


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "no_slot"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [1, 32])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_plain_matches_dense_form(K, C, dtype, kind):
    rng = np.random.RandomState(K * 100 + C)
    ids = _ids(rng, kind)
    G = len(ids)
    plan = pw.SlotPlan.build(ids, S)
    assert plan.n_parts == 2 and plan.split_slot.tolist() == [1]
    assert plan.chunk_slot.shape[0] == S + 1  # one chunk a slot, two for slot 1
    counts = np.bincount(ids[(ids >= 0) & (ids < S)], minlength=S)
    for s in range(S):  # each slot's rows ascending, as listed
        rows = plan.slot_rows[plan.slot_ptr[s]:plan.slot_ptr[s + 1]].numpy()
        assert len(rows) == counts[s] and (np.diff(rows) > 0).all()
        assert (ids[rows] == s).all()

    xg = torch.as_tensor(rng.randn(G, B, C).astype(np.float32)).to(dtype)
    p = torch.as_tensor(rng.randn(G, K).astype(np.float32))
    g = torch.as_tensor(rng.randn(K * S, B * C).astype(np.float32))
    x2 = xg.reshape(G, B * C)
    out_d, dx_d, dp_d = _dense(x2, p, ids, g)

    out = pw.pathway_fwd(x2, p, plan)
    dx, dp = pw.pathway_bwd(x2, p, g, plan)
    assert out.dtype == torch.float32 and dx.dtype == dtype and dp.dtype == torch.float32
    _close(out, out_d)
    assert torch.equal(dx, dx_d)
    _close(dp, dp_d)
    assert torch.equal(pw.pathway_fwd(x2, p, plan), out)  # repeat calls: same bits

    # the models' Function, with the fold's plan and with none (built here)
    for given in (plan, None):
        xt = xg.clone().requires_grad_(True)
        pt = p.clone().requires_grad_(True)
        res = pathway_contract(xt, pt, torch.as_tensor(ids), S, given)
        assert res.shape == (B, C, S, K)
        torch.testing.assert_close(res, out.reshape(K, S, B, C).permute(2, 3, 1, 0),
                                   rtol=0, atol=0)
        res.backward(g.reshape(K, S, B, C).permute(2, 3, 1, 0))
        assert torch.equal(xt.grad.reshape(G, B * C), dx_d)
        _close(pt.grad, dp_d)
