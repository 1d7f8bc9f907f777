"""The port's fold-parallel CV of PathCNN and vae_finetune, and its
refusals of the models the JAX package's fold-parallel cannot train, on
the CPU.

Against the JAX package's run_experiment_foldparallel on the
reference-format files of test_torch_experiment.py (60 patients, 5
pathways; f32, dropout off: the models' fixed dropouts too, by
torch_families.no_dropout), each unit starting from JAX's initial
parameters (torch_fold_parallel.JaxUnitInit): PathCNN on the PCA-row
values (learnable_pca) and on the fold's pathway image, in JAX's per-step
arm (its batches carry raw data); vae_finetune with the ConvHead and the
DiffPool head, in both JAX arms (with epoch_scan and fold_scan it takes
the one-dispatch arm).  Pooled AUC / ACC within rtol 1e-5, atol 1e-6, and
every valid and test score of every unit and epoch within 1e-5.

Against the port's sequential run_experiment with dropout on (gbm.yaml's,
and the models' fixed rates) on the synthetic cohort of
test_torch_fold_parallel.py: PathCNN (learnable_pca) and vae_finetune
(DiffPool).  The first stacked step's per-unit gradients against each
unit's own step, within 1e-5 relative: PathCNN and the DiffPool
vae_finetune.  Each unit's pathway_adj rides the stacked context.

Every other registry name fails in both packages' fold-parallel, with the
class JAX's raises (flax's InvalidRngError as a RuntimeError naming it),
before the port's optimizer makes an update.
"""
import dataclasses

import pytest
import torch
from flax.errors import InvalidRngError

from multilevel_gnn_tpu.data.synthetic import make_synthetic_cohort as jmake
from multilevel_gnn_tpu.models import pathcnn as jpathcnn
from multilevel_gnn_tpu.models import vae as jvae
from multilevel_gnn_tpu.train import driver as jdriver
from multilevel_gnn_tpu.train import fold_parallel as jfp
from multilevel_gnn_tpu_torch.core.batch import stack_contexts
from multilevel_gnn_tpu_torch.train import driver
from multilevel_gnn_tpu_torch.train import fold_parallel as fp
from multilevel_gnn_tpu_torch.train import step as S
from multilevel_gnn_tpu_torch.train.fold_parallel import run_experiment_foldparallel

from test_fold_parallel import _tiny_cfg
from test_torch_experiment import build_setup
from torch_families import no_dropout
from torch_fold_parallel import (
    FAMILIES, JaxUnitInit, ScoreSpy, check, first_step_grads_match, synthetic, tiny)
from torch_threads import few_threads  # noqa: F401  (autouse)

JAX_CASES = [
    ("pathcnn_learnable", "per-step"), ("pathcnn_attrs", "per-step"),
    ("vae_finetune_conv_head", "per-step"), ("vae_finetune_conv_head", "one-dispatch"),
    ("vae_finetune_diff_pooling", "per-step"), ("vae_finetune_diff_pooling", "one-dispatch"),
]
SMALL_HEADS = dict(epochs=2, decoder_dim=16, diff_pooling_hidden_dim=6,
                   diff_pooling_output_dim=5)
REFUSED = {
    "multiomix": AttributeError, "multiomix_gcn": AttributeError,
    "mulitomix_gcn": AttributeError, "autoencoder": TypeError, "vae": RuntimeError,
    "mmd_vae": RuntimeError, "vq_vae": KeyError,
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return build_setup(str(tmp_path_factory.mktemp("fp_families")))


@pytest.mark.parametrize("case,arm", JAX_CASES, ids=[f"{c}-{a}" for c, a in JAX_CASES])
def test_foldparallel_matches_jax(files, monkeypatch, case, arm):
    no_dropout(monkeypatch, jpathcnn, jvae)
    kw = {**FAMILIES[case], **SMALL_HEADS}
    jc, pc = files["jcohort"], files["cohort"]
    jcfg = jc.cfg.replace(**kw)
    if arm == "one-dispatch":
        jcfg = jcfg.replace(epoch_scan=True, fold_scan=True)
    carrier = JaxUnitInit(monkeypatch)
    scores = ScoreSpy(monkeypatch)
    jout = jfp.run_experiment_foldparallel(jcfg, jc)
    assert jout["arm"] == arm and len(carrier.params) == 5
    pout = fp.run_experiment_foldparallel(files["cfg"].replace(**kw), pc, device="cpu")
    assert not carrier.params and pout["units"] == 5
    check(jout, pout)
    assert len(scores.jax) == 20
    assert scores.max_abs_diff(unit_major=arm == "one-dispatch") <= 1e-5


@pytest.mark.parametrize("case", ["pathcnn_learnable", "vae_finetune_diff_pooling"])
def test_foldparallel_matches_sequential_with_dropout(case):
    cfg = tiny(**FAMILIES[case])
    assert cfg.feature_drop and cfg.dropout == 0.25
    cohort = synthetic(cfg)
    check(driver.run_experiment(cfg, cohort, device="cpu"),
          fp.run_experiment_foldparallel(cfg, cohort, device="cpu"))


def test_raw_once_per_fold_over_runs_and_groups(monkeypatch):
    """Two runs (10 units over 5 folds) of PathCNN on each fold's pathway
    image: a group keeps each fold's raw rows once (5 x P rows) and every
    unit reads its own fold's; one group and two groups equal the
    sequential protocol."""
    cfg = tiny(**FAMILIES["pathcnn_attrs"], num_run=2)
    cohort = synthetic(cfg)
    seq = driver.run_experiment(cfg, cohort, device="cpu")
    rows = []
    real = fp._Group.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        rows.append(self.raw.shape[0])

    monkeypatch.setattr(fp._Group, "__init__", spy)
    one = fp.run_experiment_foldparallel(cfg, cohort, device="cpu")
    two = fp.run_experiment_foldparallel(cfg, cohort, devices=2, device="cpu")
    P = len(cohort.patients)
    assert rows == [5 * P, 5 * P, 5 * P] and one["units"] == two["units"] == 10
    check(seq, one)
    check(one, two, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", ["pathcnn_learnable", "pathcnn_attrs",
                                  "vae_finetune_diff_pooling"])
def test_first_stacked_step_gradients_match_units(case):
    cfg = tiny(**FAMILIES[case])
    assert first_step_grads_match(cfg, synthetic(cfg)) <= 1e-5


def test_stacked_context_carries_each_units_pathway_adj():
    cfg = tiny(**FAMILIES["vae_finetune_diff_pooling"])
    cohort = synthetic(cfg)
    ctxs = []
    for f in range(5):
        tr, _, _ = driver.fold_indices(cohort.labels(), cfg, f)
        ctxs.append(driver.fold_setup(cfg, cohort, tr, f, device="cpu")[1].ctx)
    sctx = stack_contexts(ctxs)
    adj = sctx.fields["pathway_adj"]
    assert adj.shape == (5, cohort.n_pathways, cohort.n_pathways)
    for u, c in enumerate(ctxs):
        assert torch.equal(adj[u], c.pathway_adj)
    assert "edge_ids" not in sctx.fields and sctx.view.edge_id_gather is None
    with pytest.raises(ValueError, match="pathway_adj"):
        stack_contexts([ctxs[0], dataclasses.replace(ctxs[1], pathway_adj=None)])


def _jax_refusal(model, run):
    """The exception JAX's ``run`` (driver.run_experiment or
    run_experiment_foldparallel) raises for model on the tiny synthetic
    cohort of tests/test_fold_parallel.py."""
    jc = _tiny_cfg(model=model)
    with pytest.raises(Exception) as e:
        run(jc, jmake(jc, seed=0, n_patients=50, n_pathways=5))
    return e.value


def _same_failure(jerr, perr, model):
    """The port's exception of the class JAX's has (flax's InvalidRngError:
    a RuntimeError naming it and the 'sample' stream)."""
    want = REFUSED[model]
    assert type(perr) is want, (model, perr)
    if want is RuntimeError:
        assert isinstance(jerr, InvalidRngError) and 'PRNG for "sample"' in str(jerr)
        assert "InvalidRngError" in str(perr) and 'PRNG for "sample"' in str(perr)
    else:
        assert type(jerr) is want, (model, jerr)
    if want is KeyError:
        assert jerr.args == perr.args == (0,)


@pytest.mark.parametrize("model", sorted(REFUSED))
def test_refused_models_fail_as_in_jax(model, monkeypatch):
    """JAX's fold-parallel fails for these names while tracing its first
    step (multiomix.py:186, the AutoEncoder's BCE, the VAE's 'sample'
    stream, the VQ-VAE's dict output); the port's in its first stacked
    step's forward, with the same class, before any update."""
    jerr = _jax_refusal(model, jfp.run_experiment_foldparallel)
    cfg = tiny(model=model)
    updates = []
    monkeypatch.setattr(S.Optimizer, "step", lambda self: updates.append(1))
    with pytest.raises(Exception) as pe:
        run_experiment_foldparallel(cfg, synthetic(cfg), device="cpu")
    assert not updates
    _same_failure(jerr, pe.value, model)


@pytest.mark.parametrize("model", sorted(REFUSED))
def test_sequential_refusals_match_jax(model):
    """The sequential protocol fails as JAX's too: the AutoEncoder raised
    RuntimeError and the VAE KeyError here before the BCE's shape check and
    the training loss's 'sample' refusal (ROADMAP section 3)."""
    jerr = _jax_refusal(model, jdriver.run_experiment)
    cfg = tiny(model=model)
    with pytest.raises(Exception) as pe:
        driver.run_experiment(cfg, synthetic(cfg), device="cpu")
    _same_failure(jerr, pe.value, model)
