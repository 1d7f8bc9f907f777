"""Readings of the DeeperGCN parity tests (the numbers PERF.md and ROADMAP
section 3 quote, and whose doubles the tests hold):

    JAX_PLATFORMS=cpu python tests/torch_deepergcn_report.py

- GENConv bf16 per case of test_torch_deepergcn.py (genconv_rows' own
  docstring lists the columns): max|diff| / max(1, max|ref|) against JAX
  jit and JAX eager (jax.disable_jit), and GenAggregate alone;
- DeeperGCN bf16 eval (test_torch_deepergcn_model.py): probabilities
  max|diff| and loss max|diff| / max(1, |loss|) against JAX's bf16;
- five bf16 train steps (test_torch_deepergcn_train.py): losses, the same
  measure;
- run_experiment with gcn_aggr max and softmax
  (test_torch_deepergcn_protocol.py): the largest fold test-score
  difference;
- MsgNorm on a bf16 x (90, 3, 64): the port against JAX eager and JAX jit,
  and an all-float32 norm against JAX jit.
"""
import sys
import tempfile
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch
from _pytest.monkeypatch import MonkeyPatch

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

import test_torch_deepergcn as TL  # noqa: E402
import test_torch_deepergcn_bf16 as TB  # noqa: E402
import test_torch_deepergcn_model as TM  # noqa: E402
import test_torch_deepergcn_protocol as TP  # noqa: E402
import test_torch_deepergcn_train as TT  # noqa: E402
from multilevel_gnn_tpu.nn.conv import GENConv as JGENConv  # noqa: E402
from multilevel_gnn_tpu.nn.conv import GenAggregate as JGenAggregate  # noqa: E402
from multilevel_gnn_tpu.train import driver as jdriver  # noqa: E402
from multilevel_gnn_tpu_torch.data.synthetic import write_reference_format  # noqa: E402
from multilevel_gnn_tpu_torch.interop import load_flax_params  # noqa: E402
from multilevel_gnn_tpu_torch.nn.conv import GenAggregate  # noqa: E402
from multilevel_gnn_tpu_torch.train import driver  # noqa: E402


def rel(p, j):
    p, j = np.asarray(p, np.float64), np.asarray(j, np.float64)
    ok = ~np.isnan(j)
    if not ok.any():
        return 0.0
    return float(np.abs(p[ok] - j[ok]).max() / max(1.0, np.abs(j[ok]).max()))


def aggregate_rows(case):
    """GenAggregate alone against JAX eager: (f32 output, worst learnable)."""
    aggr, lt, lp, ly, _, _ = case
    jg, pg = TL._graphs()
    rng = np.random.RandomState(11)
    msg = jnp.asarray(np.maximum(rng.randn(TL.B, TL.E + TL.PAD, TL.C), 0) + 1e-7, jnp.bfloat16)
    g = rng.randn(TL.B, TL.N, TL.C).astype(np.float32)
    ja = JGenAggregate(aggr, 0.7, lt, 1.3, lp, 0.2, ly)

    def run():
        v = TB._strong(ja.init(jax.random.PRNGKey(0), msg, jg))
        with jax.disable_jit():
            out, vjp = jax.vjp(lambda v, m: ja.apply(v, m, jg), v, msg)
            return v, out, vjp(jnp.asarray(g))

    v, jo, (jv, _) = TL._pallas(run)
    pa = GenAggregate(aggr, 0.7, lt, 1.3, lp, 0.2, ly)
    load_flax_params(torch.nn.ModuleDict({"aggregate": pa}), {
        "params/aggregate/" + k.split("/")[-1]: np.asarray(a)
        for k, a in flax.traverse_util.flatten_dict(v, sep="/").items()})
    mt = torch.from_numpy(TL._nm(np.array(msg.astype(jnp.float32)))).to(torch.bfloat16)
    po = pa(mt.requires_grad_(True), pg)
    po.backward(torch.from_numpy(TL._nm(g)))
    jgr = {k.split("/")[-1]: np.asarray(a) for k, a in
           flax.traverse_util.flatten_dict(jv, sep="/").items()}
    worst = max([rel(p.grad.numpy(), jgr[k]) for k, p in pa.named_parameters()
                 if p.grad is not None] or [0.0])
    return rel(TL._nm(po.detach().numpy()), jo), worst


def genconv_rows():
    """bf16 GENConv readings, max|diff| / max(1, max|ref|):
    jit: the output, port against JAX jit and JAX eager against JAX jit;
    eager: port against JAX eager from strong params, own aggregate (out,
    dx) and JAX's aggregate handed over (out, dx, de, worst parameter);
    weak t: dx against JAX eager from the params as init leaves them;
    agg: GenAggregate alone (f32 output, worst learnable)."""
    print("GENConv bf16: jit out port | eager | eager own m: out dx | same m: out dx de "
          "param | weak-t dx | agg out param")
    worst, by_param = [0.0] * 10, {}
    for case, name in zip(TL.LAYER_CASES, TL.LAYER_IDS):
        port, ref = TL._layer(case, True)
        jit_eager = TB.eager_layer(case, same_m=False)[1]
        own = TB.eager_layer(case, same_m=False)
        same = TB.eager_layer(case)
        weak = weak_eager_dx(case)
        row = [rel(port[0], ref[0]), rel(jit_eager[0], ref[0]),
               rel(own[0][0], own[1][0]), rel(own[0][1], own[1][1]),
               rel(same[0][0], same[1][0]), rel(same[0][1], same[1][1]),
               rel(same[0][2], same[1][2]),
               max(rel(same[0][3][k], same[1][3][k]) for k in same[0][3]),
               rel(port[1], weak)] + list(aggregate_rows(case))
        worst = [max(a, b) for a, b in zip(worst + [0.0], row)]
        for k in same[0][3]:
            by_param[k] = max(by_param.get(k, 0.0), rel(same[0][3][k], same[1][3][k]))
        print(f"  {name:20s} " + " ".join(f"{v:.2e}" for v in row))
    print("  worst                " + " ".join(f"{v:.2e}" for v in worst))
    print("  same m, worst per parameter: "
          + ", ".join(f"{k} {v:.2e}" for k, v in by_param.items()))


def weak_eager_dx(case):
    """JAX eager's dx from the params as flax's init leaves them (a learned
    t weakly typed, R3), to set beside the port's."""
    jg, _ = TL._graphs()
    x, e, g = TB._inputs()
    jl = JGENConv(TL.C, TL.C, dtype=jnp.bfloat16, **TB._kw(case))

    def run():
        params = jl.init(jax.random.PRNGKey(4), jnp.asarray(x), jg, jnp.asarray(e))
        with jax.disable_jit():
            out, vjp = jax.vjp(lambda p, a: jl.apply(p, a, jg, jnp.asarray(e)), params,
                               jnp.asarray(x))
            return vjp(jnp.asarray(g).astype(out.dtype))[1]

    return np.asarray(TL._pallas(run), np.float32)


def model_rows():
    jp, pp, jl, pl = TM.eval_both(compute_dtype="bfloat16")
    print(f"DeeperGCN bf16 eval: probabilities {np.abs(pp - jp).max():.2e}, loss "
          f"{np.abs(pl - jl).max() / max(1.0, np.abs(jl).max()):.2e} (relative)")
    r = TT._train(bf16=True, **TT.CASES["max"])
    print(f"five bf16 train steps: losses "
          f"{np.abs(r['pl'] - r['jl']).max() / max(1.0, np.abs(r['jl']).max()):.2e} (relative)")
    for case in TT.CASES:
        r = TT._train(**TT.CASES[case])
        g = max(float((r["pgrad"][n] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                for n, v in r["jgrad"].items())
        print(f"f32 {case}: five steps' losses {np.abs(r['pl'] - r['jl']).max():.2e}, "
              f"first-step gradients worst {g:.2e}")


def msgnorm_rows():
    import torch

    from multilevel_gnn_tpu.nn.conv import MsgNorm as JMsgNorm
    from multilevel_gnn_tpu_torch.nn.conv import MsgNorm

    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(90, 3, 64) * 3, jnp.bfloat16)
    m = jnp.asarray(rng.randn(90, 3, 64), jnp.float32)
    jm = JMsgNorm(False)
    v = jm.init(jax.random.PRNGKey(0), x, m)
    jit = np.asarray(jax.jit(jm.apply)(v, x, m))
    with jax.disable_jit():
        eager = np.asarray(jm.apply(v, x, m))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    mt = torch.from_numpy(np.array(m))
    port = MsgNorm(False)(xt, mt).numpy()
    unit = mt / torch.clamp(torch.linalg.vector_norm(mt, dim=-1, keepdim=True), min=1e-12)
    f32 = (unit * torch.linalg.vector_norm(xt.float(), dim=-1, keepdim=True)).numpy()
    print(f"MsgNorm bf16 x (max|out| {np.abs(jit).max():.2f}): port-eager "
          f"{np.abs(port - eager).max():.2e}, port-jit {np.abs(port - jit).max():.2e}, "
          f"eager-jit {np.abs(eager - jit).max():.2e}, f32 norm-jit {np.abs(f32 - jit).max():.2e}")


def protocol_rows():
    """run_experiment's fold test scores against JAX's: softmax, max, and
    max with every relu a leaky relu (slope 0.01) on both sides (R2's
    witness: no tie at eps)."""
    import torch.nn.functional as F

    d = tempfile.mkdtemp()
    write_reference_format(d, seed=4, cancer_type="gbm", n_patients=60, n_pathways=5)
    for aggr, leaky in (("softmax", False), ("max", False), ("max", True)):
        mp = MonkeyPatch()
        try:
            if leaky:
                mp.setattr(jax.nn, "relu", lambda x: jax.nn.leaky_relu(x, 0.01))
                mp.setattr(torch, "relu", lambda x: F.leaky_relu(x, 0.01))
                mp.setattr(F, "relu", lambda x: F.leaky_relu(x, 0.01))
            mp.setattr(jdriver, "_FNS_CACHE", {})
            jax.clear_caches()
            jc, pc, cfg = TP._load(d, gcn_aggr=aggr)
            TP.InitCarrier(mp)
            jf, pf = TP._spy_results(mp, jdriver), TP._spy_results(mp, driver)
            jdriver.run_experiment(jc.cfg, jc)
            driver.run_experiment(cfg, pc, device="cpu")
        finally:
            mp.undo()
            jax.clear_caches()
        errs = [max(float(np.abs(getattr(a, k)[e] - getattr(b, k)[e]).max())
                    for k in ("epoch_pred", "epoch_pred_by_loss", "epoch_pred_by_epoch")
                    for e in getattr(b, k)) for a, b in zip(pf, jf)]
        print(f"run_experiment {aggr}{' leaky relu' if leaky else ''}: fold test scores "
              + " ".join(f"{v:.2e}" for v in errs))


if __name__ == "__main__":
    genconv_rows()
    model_rows()
    msgnorm_rows()
    protocol_rows()
