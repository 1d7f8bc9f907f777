"""Shared pieces of the fold-parallel tests of DeeperGCN, PathCNN and
vae_finetune (test_torch_fold_parallel_deepergcn.py,
test_torch_fold_parallel_families.py).

- ``tiny(**kw)`` / ``synthetic(cfg)``: gbm.yaml at small widths, f32, with
  its dropouts on, and the 50-patient synthetic cohort of
  test_torch_fold_parallel.py.
- ``check(a, b)``: pooled AUC, AUC by loss, AUC by epoch and ACC at the
  last check epoch within rtol 1e-5, atol 1e-6 (JAX's own tolerance,
  tests/test_fold_parallel.py:_check).
- ``JaxUnitInit``: JAX's run_experiment_foldparallel initial parameters of
  each unit, read where its init_state returns them (the fns of
  _shared_fns, wrapped through monkeypatch), carried into the port's units
  in the same order by replacing driver._new_model.  JAX's fold-parallel
  seeds the PCA params afterwards, as the port's does, and applies no
  apply_init_weight.
- ``ScoreSpy``: every (y, scores) that a package's metrics.eval_scores
  receives, in call order; the per-step drivers score valid, then test,
  unit by unit, every epoch (JAX's one-dispatch arm each unit's valid and
  test in turn, which max_abs_diff reorders).
- ``first_step_grads_match``: the first stacked step's per-unit gradients
  and losses against each unit's own step, with the same dropout masks
  (``stacked_first_step`` and ``unit_step_grads``).
"""
import copy
import dataclasses
from pathlib import Path

import flax
import numpy as np
import torch

from multilevel_gnn_tpu.train import fold_parallel as jfp
from multilevel_gnn_tpu.train import metrics as jmetrics
from multilevel_gnn_tpu_torch.core.batch import Batch, stack_contexts
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.data.synthetic import make_synthetic_cohort
from multilevel_gnn_tpu_torch.interop import load_flax_params
from multilevel_gnn_tpu_torch.models import get_model
from multilevel_gnn_tpu_torch.models.deepergcn import DeeperGCN
from multilevel_gnn_tpu_torch.models.multilevel_gnn import seed_pca_params
from multilevel_gnn_tpu_torch.nn.basic import UnitGenerators
from multilevel_gnn_tpu_torch.train import driver
from multilevel_gnn_tpu_torch.train import metrics as pmetrics
from multilevel_gnn_tpu_torch.train import step as S

GBM = str(Path(__file__).resolve().parents[1] / "configs" / "gbm.yaml")
TINY = dict(epochs=2, num_run=1, batch_size=8, split_shaffle=True, split_seed=3,
            node_embedding_dim=4, hidden_channels=8, final_channels=4, head_dim=16,
            conv_channel_list=[8, 16], compute_dtype=None, spmm_bf16=False,
            gnn_dropout=0.25, decoder_dim=16, diff_pooling_hidden_dim=6,
            diff_pooling_output_dim=5)
# DeeperGCN at small widths: 2 GENConv layers; all_init / head_init off,
# the one setting where JAX's fold-parallel and sequential drivers start
# from the same init
DGCN = dict(model="deepergcn", num_layers=2, all_init=False, head_init=False)
FAMILIES = {
    "deepergcn_max": dict(DGCN, gcn_aggr="max"),
    "deepergcn_softmax": dict(DGCN, gcn_aggr="softmax"),
    "pathcnn_learnable": dict(model="pathcnn", learnable_pca=True),
    "pathcnn_attrs": dict(model="pathcnn", learnable_pca=False),
    "vae_finetune_conv_head": dict(model="vae_finetune"),
    "vae_finetune_diff_pooling": dict(model="vae_finetune", reorder_type="diff_pooling"),
}
KEYS = ("auc", "auc_by_loss", "auc_by_epoch", "acc")


def tiny(**kw) -> Config:
    return Config.from_yaml(GBM, **{**TINY, **kw})


def synthetic(cfg):
    return make_synthetic_cohort(cfg, seed=0, n_patients=50, n_pathways=5)


def check(a, b, rtol=1e-5, atol=1e-6):
    e = a["check_epochs"][-1]
    assert b["check_epochs"] == a["check_epochs"]
    for key in KEYS:
        np.testing.assert_allclose(b[key][e], a[key][e], rtol=rtol, atol=atol, err_msg=key)


def flat(params) -> dict:
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(params, sep="/").items()}


def port_model(cfg, ctx):
    """A model of cfg.model for ctx, its parameters to be loaded."""
    if get_model(cfg.model) is DeeperGCN:
        return DeeperGCN(cfg, device=ctx.device)
    return get_model(cfg.model)(cfg, ctx.graph.n_nodes, ctx.num_pca_rows, device=ctx.device)


class JaxUnitInit:
    """JAX's fold-parallel initial parameters of each unit, in unit order,
    as the port's fold-parallel units (module docstring)."""

    def __init__(self, monkeypatch):
        self.params = []
        real = jfp._shared_fns

        def shared(cfg, cohort, steps_per_epoch):
            model, fns = real(cfg, cohort, steps_per_epoch)

            def init_state(*a, **k):
                params, opt_state = fns.init_state(*a, **k)
                self.params.append(flat(params))
                return params, opt_state

            return model, dataclasses.replace(fns, init_state=init_state)

        monkeypatch.setattr(jfp, "_shared_fns", shared)
        monkeypatch.setattr(driver, "_new_model", self.new_model)

    def new_model(self, cfg, ctx, seed, init_weight=True):
        m = port_model(cfg, ctx)
        load_flax_params(m, self.params.pop(0))
        return m


class ScoreSpy:
    """The scores each package's eval_scores receives (module docstring)."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        for module, out in ((jmetrics, self.jax), (pmetrics, self.port)):
            real = module.eval_scores

            def spy(y, pred, real=real, out=out):
                out.append(np.asarray(pred, np.float64).copy())
                return real(y, pred)

            monkeypatch.setattr(module, "eval_scores", spy)

    def max_abs_diff(self, units: int = 5, unit_major: bool = False) -> float:
        """unit_major: JAX's one-dispatch arm scores each unit's valid and
        test split in turn, every epoch."""
        jax = self.jax
        assert len(jax) == len(self.port) > 0
        if unit_major:
            n = 2 * units
            jax = [jax[e * n + 2 * u + split] for e in range(len(jax) // n)
                   for split in (0, 1) for u in range(units)]
        return max(float(np.abs(a - b).max()) for a, b in zip(jax, self.port))


def _unit(cfg, cohort, fold_i):
    """Fold fold_i's unit of run 0: its model as fold-parallel builds it,
    context, first shuffled train batch (raw_data included) and class
    weights."""
    tr, _, _ = driver.fold_indices(cohort.labels(), cfg, fold_i)
    fcfg, fold, X = driver.fold_setup(cfg, cohort, tr, fold_i, device="cpu")
    fcfg = fcfg.replace(pathway_num=cohort.n_pathways)
    seed = cfg.seed * 10_000 + fold_i
    model = driver._new_model(fcfg, fold.ctx, seed, init_weight=False)
    if fcfg.init_with_pca and fold.ctx.pca_seed is not None:
        seed_pca_params(model, fold.ctx.pca_seed)
    take, mask, _ = next(driver.epoch_plan(X, tr, cfg.batch_size,
                                           np.random.RandomState(seed), True, True))

    def rows(a):
        return torch.from_numpy(np.asarray(a[take], np.float32))

    batch = Batch(x=rows(X), y=rows(cohort.Y), age=rows(cohort.ages),
                  sample_mask=torch.from_numpy(mask),
                  raw_data=rows(fold.raw) if fold.raw is not None else None)
    return dict(cfg=fcfg, ctx=fold.ctx, model=model, batch=batch, seed=seed,
                cw=torch.tensor(fold.class_weight, dtype=torch.float32))


def stacked_first_step(cfg, cohort):
    """The five folds' units (_unit) and their first stacked step, its
    update off: (units, the stacked params with their gradients, the (U,)
    losses)."""
    units = [_unit(cfg, cohort, f) for f in range(5)]
    sctx = stack_contexts([u["ctx"] for u in units])
    params = S.stack_params([u["model"] for u in units])
    opt = S.Optimizer(list(params.values()), units[0]["cfg"], 4, units=5)
    opt.step = lambda: None  # the gradients before the update
    gens = UnitGenerators(torch.Generator().manual_seed(u["seed"]) for u in units)
    fields = ("x", "y", "age", "sample_mask", "raw_data")
    batch = Batch(**{f: None if getattr(units[0]["batch"], f) is None else
                     torch.stack([getattr(u["batch"], f) for u in units]) for f in fields})
    losses = S.stacked_train_step(copy.deepcopy(units[0]["model"]), params, opt, batch, sctx,
                                  torch.stack([u["cw"] for u in units]), gens)
    return units, params, losses


def unit_step_grads(u) -> torch.Tensor:
    """A unit's own training loss and backward (its model's .grad), with
    the dropout masks of its generator; returns the loss."""
    m = u["model"]
    m.train()
    m.zero_grad()
    loss, _ = S.make_loss_fn(u["cfg"])(m, u["batch"], u["ctx"], u["cw"],
                                       torch.Generator().manual_seed(u["seed"]))
    loss.backward()
    return loss.detach()


def first_step_grads_match(cfg, cohort, tol=1e-5, zero=()):
    """The first stacked step of the five folds' units against each unit's
    own loss and backward (module docstring): losses and every parameter's
    gradient within tol of the unit's (relative to its largest element).
    zero: parameters whose gradient is 0 in exact arithmetic, so both
    sides hold rounding only: each within tol of the unit's largest
    gradient of any parameter."""
    units, params, losses = stacked_first_step(cfg, cohort)
    worst = 0.0
    for i, u in enumerate(units):
        loss = unit_step_grads(u)
        assert abs(float(loss) - float(losses[i])) <= tol * abs(float(loss))
        m = u["model"]
        refs = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                for k, p in m.named_parameters()}
        largest = max(float(r.abs().max()) for r in refs.values())
        for k, ref in refs.items():
            got = params[k].grad[i] if params[k].grad is not None else torch.zeros_like(ref)
            if k in zero:
                assert max(float(got.abs().max()), float(ref.abs().max())) <= tol * largest, k
                continue
            err = float((got - ref).abs().max())
            assert err <= tol * float(ref.abs().max()), (i, k, err)
            worst = max(worst, err / max(float(ref.abs().max()), 1e-30))
    return worst
