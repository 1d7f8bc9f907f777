"""Shared inputs of the PathCNN / DiffPool / AE / VAE / VQ-VAE parity tests
(test_torch_pathcnn.py, test_torch_diffpool.py, test_torch_autoencoder.py,
test_torch_vae.py, test_torch_pretrain.py).

small_fold() builds, once per process, the JAX package's 30-patient,
5-pathway synthetic cohort (test_model_families.py's) and its fold 0 over
the first 18 patients, carries the fold into a port FoldContext on the CPU
(pathway_adj included) and makes one batch of 8 patients, PCA-row values
in raw_data, for both packages.  JAX runs with the 'pallas' backend (its
kernels in interpret mode) under jax.jit.

init_pair(jmodel, jbatch) draws the JAX parameters and loads them into
the port model through interop.py.  experiments_match runs both packages'
run_experiment with every port fold started from the JAX fold's initial
parameters (test_torch_experiment.InitCarrier).
"""
import contextlib
import functools
import types

import flax
import flax.linen as fnn
import jax
import numpy as np
import torch

from multilevel_gnn_tpu.core.batch import Batch as JBatch
from multilevel_gnn_tpu.data.synthetic import make_synthetic_cohort
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu.train import driver as jdriver
from multilevel_gnn_tpu_torch.core.batch import Batch, make_fold_context
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.interop import load_flax_params
from multilevel_gnn_tpu_torch.models import get_model
from multilevel_gnn_tpu_torch.nn import basic as pbasic
from multilevel_gnn_tpu_torch.train import driver

from test_data_pipeline import gbm_like_cfg
from test_torch_experiment import InitCarrier, _spy_results
from test_torch_experiment import _close_scores as close_scores

B = 8
# small widths, f32, dropout off (the models' fixed dropouts: no_dropout)
SMALL = dict(node_embedding_dim=4, hidden_channels=8, final_channels=4, head_dim=16,
             conv_channel_list=[8, 16], decoder_dim=16, feature_drop=False,
             head_drop_rate=0.0, gnn_dropout=0.0, batch_size=B, kernel_backend="pallas",
             diff_pooling_hidden_dim=6, diff_pooling_output_dim=5, vqvae_num_embeddings=16)


def rel_err(a, ref) -> float:
    """max|a - ref| / max(1, max|ref|)."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(1.0, float(np.abs(ref).max())))


def flat(tree):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def port_cfg(jcfg) -> Config:
    return Config.from_dict({f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})


@contextlib.contextmanager
def pallas():
    prev = jspmm.get_backend()
    jspmm.set_backend("pallas")
    try:
        yield
    finally:
        jspmm.set_backend(prev)


@functools.lru_cache(maxsize=None)
def small_fold():
    jcfg = gbm_like_cfg(**SMALL)
    cohort = make_synthetic_cohort(jcfg, seed=0, n_patients=30, n_pathways=5)
    jcfg = jcfg.replace(pathway_num=cohort.n_pathways, node_num=cohort.num_nodes // 3,
                        slot_sizes=cohort.slot_sizes())
    fold = cohort.fold(np.arange(18), 0)
    jg = fold.ctx.graph
    mask = np.asarray(jg.edge_mask)
    g = Graph(senders=np.asarray(jg.senders), receivers=np.asarray(jg.receivers),
              edge_attr=np.asarray(jg.edge_attr), edge_mask=mask, n_nodes=jg.n_nodes,
              n_edges=int(mask.sum())).with_sorted_meta("cpu")
    pctx = make_fold_context(
        g, np.asarray(fold.ctx.gene_pca_match), np.asarray(fold.ctx.raw_indice),
        fold.info_mask, fold.reorder_idxs, pca_seed=fold.pca_seed,
        n_pathways=cohort.n_pathways, device="cpu")
    import dataclasses

    pctx = dataclasses.replace(
        pctx, pathway_adj=torch.from_numpy(np.array(fold.ctx.pathway_adj)))
    pos = {p: i for i, p in enumerate(cohort.pca_patients)}
    raw = cohort.raw_datas[[pos[p] for p in cohort.patients]].astype(np.float32)
    attr = fold.pathway_node_attr.astype(np.float32).reshape(len(cohort.patients), -1)
    return dict(jcfg=jcfg, cohort=cohort, fold=fold, jctx=fold.ctx, pctx=pctx,
                raw=raw, attr=attr, std_w=np.asarray(cohort.gene_std_value))


def batches(side_raw="raw", n=B, start=0):
    """(JAX Batch, port Batch) of patients start .. start + n, raw_data
    the PCA-row values ('raw'), the fold's PCA attrs ('attr') or None."""
    f = small_fold()
    c = f["cohort"]
    sl = slice(start, start + n)
    arrs = dict(x=c.X[sl].astype(np.float32), y=c.Y[sl].astype(np.float32),
                age=c.ages[sl].astype(np.float32))
    raw = f[side_raw][sl] if side_raw else None
    jb = JBatch(x=jax.numpy.asarray(arrs["x"]), y=jax.numpy.asarray(arrs["y"]),
                age=jax.numpy.asarray(arrs["age"]), sample_mask=jax.numpy.ones(n, bool),
                raw_data=None if raw is None else jax.numpy.asarray(raw))
    pb = Batch(x=torch.from_numpy(arrs["x"]), y=torch.from_numpy(arrs["y"]),
               age=torch.from_numpy(arrs["age"]), sample_mask=torch.ones(n, dtype=torch.bool),
               raw_data=None if raw is None else torch.from_numpy(raw))
    return jb, pb


def init_pair(jmodel, jbatch, pcls=None, seed=0, **apply_kw):
    """JAX params of jmodel (PRNGKey(seed), strong-typed) and the port model
    of the same config carrying them; pcls: the port class (the registry's
    class of cfg.model by default)."""
    f = small_fold()
    cfg = port_cfg(jmodel.cfg)
    with pallas():
        params = jax.jit(lambda k: jmodel.init(k, jbatch, f["jctx"], False, **apply_kw))(
            jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(lambda a: jax.numpy.asarray(np.asarray(a)), params)
    pcls = pcls or get_model(cfg.model)
    pm = pcls(cfg, f["pctx"].graph.n_nodes, f["pctx"].num_pca_rows, device="cpu")
    load_flax_params(pm, flat(params))
    return params, pm


def grads_by_name(jgrads) -> dict:
    """JAX gradients by the port's parameter names."""
    from multilevel_gnn_tpu_torch.interop import state_dict_from_flax

    return {k: v.numpy() for k, v in state_dict_from_flax(flat(jgrads)).items()}


def check_grads(pm, jgrads, tol=1e-5, residue=None):
    """Every parameter's gradient within tol * max(1, max|ref|), or within
    the limit ``residue`` names for it (twice a reading of ROADMAP section
    3)."""
    residue = residue or {}
    jg = grads_by_name(jgrads)
    # a parameter the forward does not reach has no .grad: JAX's zeros
    pg = {n: p.grad if p.grad is not None else torch.zeros_like(p)
          for n, p in pm.named_parameters()}
    assert set(jg) == set(pg), sorted(set(jg) ^ set(pg))
    for n, g in jg.items():
        err = rel_err(pg[n].numpy(), g)
        assert err <= residue.get(n, tol), (n, err)


def vjp_pair(jm, params, jb, pm, pb, seed=0, **apply_kw):
    """The training-mode forward's VJP at seeded N(0, 1) cotangents on its
    array outputs (probabilities, image, ...), on both sides, in one jit:
    JAX's outputs and parameter gradients, and the port's gradients left
    in pm's .grad.  With dropout off the training-mode outputs are the
    eval-mode ones.  A classifier whose softmax is saturated (the raw age,
    up to 80, enters the head: probabilities within 3e-7 of 1 here) makes
    the BCE loss's gradient ill-conditioned in f32 (both packages 0.3% away
    from the float64 gradient); the VJP at a fixed cotangent keeps only the
    softmax's own rounding, on head_0's weight (ROADMAP section 3, R6)."""
    f = small_fold()

    def fwd(p):
        return jm.apply(p, jb, f["jctx"], True, **apply_kw)

    rng = np.random.RandomState(seed)
    cots = tuple(jax.numpy.asarray(np.asarray(rng.randn(*o.shape), np.float32))
                 for o in jax.eval_shape(fwd, params))
    with pallas():
        jout, jg = jax.jit(lambda p: (lambda o, v: (o, v(cots)[0]))(*jax.vjp(fwd, p)))(params)
    pm.train()
    pm.zero_grad(set_to_none=True)
    pout = pm(pb, f["pctx"], torch.Generator().manual_seed(0))
    outs = [(o, torch.from_numpy(np.asarray(c))) for o, c in zip(pout, cots)
            if torch.is_tensor(o) and o.requires_grad]
    torch.autograd.backward([o for o, _ in outs], [c for _, c in outs])
    return jout, jg


class NoDropout(fnn.Module):
    """flax's Dropout at rate 0, for the models whose dropout rates are
    fixed (PathCNN's 0.25 / 0.5, the DiffPool head's 0.5): their jax.random
    masks cannot be drawn in torch."""

    rate: float = 0.0
    deterministic: bool = None

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def no_dropout(monkeypatch, *jax_modules):
    """Dropout off in the port and in the JAX modules named (their ``nn``
    is flax.linen, seen with Dropout replaced by NoDropout)."""
    shim = types.SimpleNamespace(**{**vars(fnn), "Dropout": NoDropout})
    for m in jax_modules:
        monkeypatch.setattr(m, "nn", shim)
    monkeypatch.setattr(pbasic.Dropout, "forward", lambda self, x, generator=None: x)


def experiments_match(jc, pc, cfg, monkeypatch, jcfg=None, port_run=None, **run_kw):
    """run_experiment of both packages, each fold starting from JAX's
    initial parameters: every fold's test scores within 1e-5 and the pooled
    AUC / ACC equal.  run_kw: both run_experiment's extra arguments;
    port_run: the port's run (run_experiment on the CPU by default)."""
    carrier = InitCarrier(monkeypatch)
    jfolds = _spy_results(monkeypatch, jdriver)
    pfolds = _spy_results(monkeypatch, driver)
    jout = jdriver.run_experiment(jcfg or jc.cfg, jc, **run_kw)
    pout = (port_run() if port_run is not None
            else driver.run_experiment(cfg, pc, device="cpu", **run_kw))
    assert not carrier.params and len(jfolds) == len(pfolds) == 5
    for a, b in zip(pfolds, jfolds):
        close_scores(a, b)
    for key in ("auc", "auc_by_loss", "auc_by_epoch", "acc", "acc_by_loss", "acc_by_epoch"):
        assert pout[key] == jout[key], key
    return pout, jout
