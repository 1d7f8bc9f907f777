"""The port's radam and adamw against optax's chains in the JAX package's
make_optimizer (train/step.py:136-156), and the optimizers' state_dict.

- radam / adamw: 10 updates of a toy tree from the same gradients (norms
  above and below the clip at 20), with clip, StepLR, warmup and weight
  decay on, and with all of them off: parameters within 1e-6 absolute of
  optax's after every update.
- radam with weight decay adds +wd * p after the learning-rate scale, as
  the JAX chain does: one zero-gradient step from ones at wd 0.1 gives 1.1
  in both packages.
- adam / radam / adamw: 5 updates, the state_dict saved and loaded into a
  fresh optimizer over a copy of the parameters, 5 more updates: equal to
  10 updates in one optimizer.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.train import step as jstep
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.train import step as pstep

SHAPES = {"a": (5, 3), "b": (7,)}
ON = dict(lr=1e-2, clip_grad=True, step=1, gamma=0.5, warmup_epochs=1,
          warmup_lr=1e-3, wd=0.1, beta1=0.8, beta2=0.95)
OFF = dict(lr=1e-2, clip_grad=False, step=0, warmup_epochs=0, wd=0.0,
           beta1=0.8, beta2=0.95)
SPE = 3


def _data(seed=7, n=10):
    rng = np.random.RandomState(seed)
    init = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * (12.0 if i % 2 else 1.0)).astype(np.float32)
              for k, s in SHAPES.items()} for i in range(n)]
    return init, grads


def _module(init):
    m = torch.nn.Module()
    for k, v in init.items():
        m.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    return m


def _step(module, opt, grads):
    for k, v in grads.items():
        getattr(module, k).grad = torch.from_numpy(v.copy())
    opt.step()


@pytest.mark.parametrize("name", ["radam", "adamw"])
@pytest.mark.parametrize("kw", [ON, OFF], ids=["clip_warmup_steplr_wd", "plain"])
def test_optimizer_matches_optax(name, kw):
    init, grads = _data()
    tx = jstep.make_optimizer(JConfig(**kw), SPE, name=name)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    module = _module(init)
    opt = pstep.make_optimizer(module, Config(**kw), SPE, name=name)
    for gr in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in gr.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        _step(module, opt, gr)
        for k in SHAPES:
            np.testing.assert_allclose(getattr(module, k).detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6)
    assert opt.count == len(grads)


def test_radam_weight_decay_grows_weights():
    kw = dict(lr=1e-2, wd=0.1, step=0, clip_grad=False)
    tx = jstep.make_optimizer(JConfig(**kw), SPE, name="radam")
    p = {"w": jnp.ones((3,))}
    upd, _ = tx.update({"w": jnp.zeros((3,))}, tx.init(p), p)
    jw = np.asarray(optax.apply_updates(p, upd)["w"])
    module = _module({"w": np.ones(3, np.float32)})
    opt = pstep.make_optimizer(module, Config(**kw), SPE, name="radam")
    _step(module, opt, {"w": np.zeros(3, np.float32)})
    np.testing.assert_allclose(jw, 1.1, rtol=1e-6)
    np.testing.assert_array_equal(module.w.detach().numpy(), jw)


@pytest.mark.parametrize("name", ["adam", "radam", "adamw"])
def test_state_dict_resumes_exactly(name):
    init, grads = _data(seed=3)
    a = _module(init)
    opt_a = pstep.make_optimizer(a, Config(**ON), SPE, name=name)
    for gr in grads:
        _step(a, opt_a, gr)
    b = _module(init)
    opt_b = pstep.make_optimizer(b, Config(**ON), SPE, name=name)
    for gr in grads[:5]:
        _step(b, opt_b, gr)
    state = opt_b.state_dict()
    c = _module({k: getattr(b, k).detach().numpy() for k in SHAPES})
    opt_c = pstep.make_optimizer(c, Config(**ON), SPE, name=name)
    opt_c.load_state_dict(state)
    assert opt_c.count == 5
    for gr in grads[5:]:
        _step(c, opt_c, gr)
    for k in SHAPES:
        torch.testing.assert_close(getattr(c, k), getattr(a, k), rtol=0, atol=0)
    with pytest.raises(ValueError):
        pstep.make_optimizer(_module(init), Config(**ON), SPE,
                             name="adamw" if name != "adamw" else "adam"
                             ).load_state_dict(state)
