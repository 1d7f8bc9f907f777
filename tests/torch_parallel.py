"""Shared pieces of the port's mesh tests (test_torch_edge_partition.py,
test_torch_halo.py, test_torch_parallel.py, test_torch_parallel_driver.py).

Every multi-rank case runs in one group of spawned gloo processes per test
module (parallel/multihost.py:spawn, with a 120 s group timeout and a join
deadline), on a module-scoped fixture that computes all of the module's
cases at once; the parametrised tests read its results.  The functions a
rank runs live here, importable by name, and import neither jax nor the
JAX package: the tests hold their results against JAX in the test process.

- ``graph_arrays(kind)``: host edges, attrs and node count of the test
  graphs (JAX's community_graph, a ragged random graph, a graph whose
  maxima tie across ranks, one with negative maxima on rows that some
  ranks hold no edge of); ``features(seed, n)``: node-major (N, B, C) x and
  a cotangent t.
- ``agg_rank``: the edge-partitioned and halo aggregations on a rank,
  forward and the input gradient (the ranks' shares summed).
- ``step_setup`` / ``single_step`` / ``step_rank``: one train step of a
  tiny config from gbm.yaml (its dropouts on), single device or on a D x M
  mesh: loss, parameters after the step and gradients.
- ``experiment_rank``: run_experiment cases on a mesh, each returning its
  result or its error's type and text.
"""
import dataclasses
import traceback
from pathlib import Path

import numpy as np
import torch

from multilevel_gnn_tpu_torch.core.batch import Batch
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.data.synthetic import make_synthetic_cohort
from multilevel_gnn_tpu_torch.ops import spmm
from multilevel_gnn_tpu_torch.parallel import halo as PH
from multilevel_gnn_tpu_torch.parallel import mesh as PM
from multilevel_gnn_tpu_torch.parallel.multihost import spawn
from multilevel_gnn_tpu_torch.train import driver
from multilevel_gnn_tpu_torch.train import step as S

GBM = str(Path(__file__).resolve().parents[1] / "configs" / "gbm.yaml")
# gbm.yaml at small widths, f32, its dropouts on (feature_drop, head
# dropout, gnn_dropout 0.25), as tests/torch_fold_parallel.py:TINY
TINY = dict(epochs=2, num_run=1, batch_size=8, split_shaffle=True, split_seed=3,
            node_embedding_dim=4, hidden_channels=8, final_channels=4, head_dim=16,
            conv_channel_list=[8, 16], compute_dtype=None, spmm_bf16=False,
            gnn_dropout=0.25, decoder_dim=16, diff_pooling_hidden_dim=6,
            diff_pooling_output_dim=5)
DGCN = dict(model="deepergcn", num_layers=2, all_init=False, head_init=False)
GROUP_TIMEOUT_S = 120
B, C = 2, 16


def tiny(**kw) -> Config:
    return Config.from_yaml(GBM, **{**TINY, **kw})


def synthetic(cfg):
    return make_synthetic_cohort(cfg, seed=0, n_patients=50, n_pathways=5)


def run_ranks(fn, n, *args, deadline_s=600):
    return spawn(fn, n, *args, backend="gloo", deadline_s=deadline_s,
                 timeout_s=GROUP_TIMEOUT_S)


# ---- the aggregation cases


def graph_arrays(kind: str):
    """(edges (2, E) int, attr (E,) float32, n_nodes) of a test graph."""
    if kind == "community":  # tests/test_halo.py:community_graph, k = 4
        rng = np.random.RandomState(3)
        n, intra, cross, K = 512, 3000, 120, 4
        nl = n // K
        s, d = [], []
        for p in range(K):
            s.append(rng.randint(p * nl, (p + 1) * nl, size=intra // K))
            d.append(rng.randint(p * nl, (p + 1) * nl, size=intra // K))
        s.append(rng.randint(0, n, size=cross))
        d.append(rng.randint(0, n, size=cross))
        edges = np.stack([np.concatenate(s), np.concatenate(d)])
        return edges, rng.rand(edges.shape[1]).astype(np.float32), n
    if kind == "ragged":  # N not a multiple of k, a node with no edge
        rng = np.random.RandomState(5)
        n = 203
        e = rng.randint(0, n - 1, size=(2, 1501))
        return e, rng.rand(e.shape[1]).astype(np.float32), n
    if kind == "random":  # tests/test_edge_partition.py's shape
        rng = np.random.RandomState(0)
        n = 60
        e = rng.randint(0, n, size=(2, 500))
        return e, rng.rand(500).astype(np.float32), n
    if kind == "ties":  # equal messages from senders on different ranks
        rng = np.random.RandomState(1)
        n = 40
        e = rng.randint(0, n, size=(2, 400))
        return e, np.ones(400, np.float32), n
    if kind == "negative":  # few in-edges a row: rows empty on some ranks
        rng = np.random.RandomState(2)
        n = 64
        e = rng.randint(0, n, size=(2, 90))
        return e, rng.rand(90).astype(np.float32) + 0.5, n
    raise ValueError(kind)


def port_graph(kind: str) -> Graph:
    edges, attr, n = graph_arrays(kind)
    return Graph.from_edges(edges, attr, n).with_sorted_meta("cpu")


def features(kind: str, n: int):
    """(x, t): node-major (N, B, C) float32 host arrays; 'ties' draws small
    integers (messages tie), 'negative' values below -1 (maxima < 0)."""
    rng = np.random.RandomState(11)
    if kind == "ties":
        x = rng.randint(0, 3, size=(n, B, C)).astype(np.float32)
    elif kind == "negative":
        x = -1.0 - rng.rand(n, B, C).astype(np.float32)
    else:
        x = rng.randn(n, B, C).astype(np.float32)
    return x, rng.randn(n, B, C).astype(np.float32)


def single_agg(kind, reduce, weighted):
    """The port's single-device gather_scatter: (out, dx) of sum(out * t)."""
    g = port_graph(kind)
    x, t = features(kind, g.n_nodes)
    xv = torch.tensor(x, requires_grad=True)
    out = spmm.gather_scatter(xv, g, reduce, g.edge_attr if weighted else None)
    (out * torch.tensor(t)).sum().backward()
    return out.detach().numpy(), xv.grad.numpy()


def agg_rank(rank: int, cases) -> dict:
    """cases: {name: (kind, reduce, weighted, form)}, form 'edge', 'halo' or
    'halo_windowed', on a 1 x k mesh (k = the group's size): the rank's
    (out, dx) with dx the ranks' shares summed."""
    import torch.distributed as dist

    k = dist.get_world_size()
    mesh = PM.make_mesh(1, k)
    res = {}
    for name, (kind, reduce, weighted, form) in cases.items():
        g = port_graph(kind)
        sg = PM.edge_block(g, k, mesh.model_rank, mesh.model_group)
        if form != "edge":
            hp = PH.build_halo_partition(PM.padded_graph(g, k), k,
                                         windowed=form == "halo_windowed")
            sg = dataclasses.replace(sg, halo=hp.for_rank(mesh.model_rank,
                                                          mesh.model_group, "cpu", g))
        x, t = features(kind, g.n_nodes)
        xv = torch.tensor(x, requires_grad=True)
        out = spmm.gather_scatter(xv, sg, reduce, sg.edge_attr if weighted else None)
        (out * torch.tensor(t)).sum().div(k).backward()
        dx = xv.grad.clone()
        dist.all_reduce(dx)
        res[name] = (out.detach().numpy(), dx.numpy())
    return res


# ---- one train step


def step_setup(cfg):
    """(fold cfg, fold ctx, batch, class weight, seed) of fold 0's first 8
    training rows, on the CPU."""
    cohort = synthetic(cfg)
    tr, _, _ = driver.fold_indices(cohort.labels(), cfg, 0)
    fcfg, fold, X = driver.fold_setup(cfg, cohort, tr, 0, device="cpu")
    fcfg = fcfg.replace(pathway_num=cohort.n_pathways)
    take = np.asarray(tr[: cfg.batch_size])

    def t(a):
        return torch.as_tensor(np.asarray(a[take], np.float32))

    batch = Batch(x=t(X), y=t(cohort.Y), age=t(cohort.ages),
                  sample_mask=torch.ones(len(take), dtype=torch.bool),
                  raw_data=t(fold.raw) if fold.raw is not None else None)
    cw = torch.as_tensor(np.asarray(fold.class_weight, np.float32))
    return fcfg, fold.ctx, batch, cw, 1234


def _model(fcfg, ctx, seed):
    from multilevel_gnn_tpu_torch.models.multilevel_gnn import seed_pca_params

    model = driver._new_model(fcfg, ctx, seed)
    if fcfg.init_with_pca and ctx.pca_seed is not None:
        seed_pca_params(model, ctx.pca_seed)
    return model


def _step_out(model, loss):
    return {"loss": float(loss),
            "params": {k: v.detach().numpy().copy() for k, v in model.named_parameters()},
            "grads": {k: (v.grad.numpy().copy() if v.grad is not None else None)
                      for k, v in model.named_parameters()}}


def single_step(kw) -> dict:
    """train_step on one device of tiny(**kw)'s setup."""
    fcfg, ctx, batch, cw, seed = step_setup(tiny(**kw))
    model = _model(fcfg, ctx, seed)
    opt = S.make_optimizer(model, fcfg, 1)
    loss = S.train_step(model, opt, batch, ctx, cw, torch.Generator().manual_seed(seed))
    return _step_out(model, loss)


def mesh_step(kw, n_data: int, n_model: int) -> dict:
    """train_step of the same setup on this rank's mesh."""
    fcfg, ctx, batch, cw, seed = step_setup(tiny(**kw))
    mesh = PM.make_mesh(n_data, n_model)
    ctx = driver.mesh_ctx(fcfg, ctx, mesh)
    model = _model(fcfg, ctx, seed)
    PM.replicate(model, mesh)
    opt = S.make_optimizer(model, fcfg, 1)
    loss = S.train_step(model, opt, batch, ctx, cw, torch.Generator().manual_seed(seed), mesh)
    return _step_out(model, loss)


def step_rank(rank: int, n_data: int, n_model: int, cases) -> dict:
    """{name: mesh_step(kw)} for cases {name: kw}; rank 0's only (the
    others return whether their parameters equal rank 0's)."""
    import torch.distributed as dist

    out = {}
    for name, kw in cases.items():
        r = mesh_step(kw, n_data, n_model)
        flat = torch.cat([torch.as_tensor(v).reshape(-1) for v in r["params"].values()])
        ref = flat.clone()
        dist.broadcast(ref, 0)
        r["equal_to_rank0"] = bool(torch.equal(flat, ref))
        out[name] = r if rank == 0 else {"equal_to_rank0": r["equal_to_rank0"]}
    return out


# ---- the protocol


def experiment_rank(rank: int, cases, inits=None, files=None) -> dict:
    """{name: run_experiment(...)} for cases {name: (config kw, mesh
    (D, M), run_experiment kw)} on the CPU; a case that raises gives
    {"error": type name, "message": its text}.  inits: {name: [flat flax
    params of each fold]}, loaded in turn in place of the seeded models.
    files: (config path, {loader path kw}): the cohort read from
    reference-format files under that config (cfg = the config with kw),
    in place of tiny(**kw)'s synthetic cohort."""
    from multilevel_gnn_tpu_torch.data import loaders

    out = {}
    real = driver._new_model
    for name, (kw, (d, m), rkw) in cases.items():
        if files is None:
            cfg = tiny(**kw)
            cohort = synthetic(cfg)
        else:
            cfg = Config.from_yaml(files[0], **kw)
            cohort = loaders.load_cohort_from_files(cfg=cfg, **files[1])
        cfg = cfg.replace(mesh_data_axis=d, mesh_model_axis=m)
        if inits is not None and name in inits:
            driver._new_model = _InitFrom(inits[name]).new_model
        try:
            out[name] = driver.run_experiment(cfg, cohort, device="cpu", **rkw)
        except (Exception, KeyboardInterrupt) as e:  # compared with the sequential driver's
            out[name] = {"error": type(e).__name__, "message": str(e),
                         "trace": traceback.format_exc()}
        finally:
            driver._new_model = real
    return out


class _InitFrom:
    """A fold model of cfg.model loaded with the next of the given flat
    flax parameter dicts (the JAX package's initial parameters)."""

    def __init__(self, params):
        self.params = list(params)

    def new_model(self, cfg, ctx, seed, init_weight=True):
        from multilevel_gnn_tpu_torch.interop import load_flax_params
        from multilevel_gnn_tpu_torch.models import get_model

        m = get_model(cfg.model)(cfg, ctx.graph.n_nodes, ctx.num_pca_rows, device=ctx.device)
        load_flax_params(m, self.params.pop(0))
        return m


def sequential_error(kw) -> tuple:
    """The sequential driver's error on tiny(**kw), (type name, text)."""
    cfg = tiny(**kw)
    try:
        driver.run_experiment(cfg, synthetic(cfg), device="cpu")
    except Exception as e:
        return type(e).__name__, str(e)
    return None, None


# ---- the collectives and the mesh


def comm_rank(rank: int) -> dict:
    """On a 2 x 2 mesh: the rank's place and groups, each collective's
    forward and its backward's share (seeded with the cotangent
    (rank + 1) * ones), and make_mesh's refusals."""
    import torch.distributed as dist

    from multilevel_gnn_tpu_torch.parallel import comm

    mesh = PM.make_mesh(2, 2)
    out = {"place": (mesh.data_rank, mesh.model_rank, mesh.rank),
           "model_ranks": dist.get_process_group_ranks(mesh.model_group),
           "data_ranks": dist.get_process_group_ranks(mesh.data_group)}
    g = mesh.model_group
    x = torch.full((2, 3), float(rank), requires_grad=True)
    y = comm.all_gather_rows(x, g)
    (y * (rank + 1)).sum().backward()
    out["all_gather_rows"] = (y.detach().numpy(), x.grad.numpy())
    x = torch.arange(8.0).reshape(4, 2).requires_grad_(True)
    y = comm.local_block(x, g, 2)
    (y * (rank + 1)).sum().backward()
    out["local_block"] = (y.detach().numpy(), x.grad.numpy())
    x = (torch.arange(6.0).reshape(2, 3) + 10 * rank).requires_grad_(True)
    y = comm.all_to_all(x, g)
    (y * torch.arange(6.0).reshape(2, 3) * (rank + 1)).sum().backward()
    out["all_to_all"] = (y.detach().numpy(), x.grad.numpy())
    x = torch.full((3,), float(rank + 1), requires_grad=True)
    y = comm.from_model_region(x, g)
    (y * (rank + 1)).sum().backward()
    out["from_model_region"] = (y.detach().numpy(), x.grad.numpy())
    refused = []
    for d, m in ((3, 2), (1, 2)):
        try:
            PM.make_mesh(d, m)
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = refused
    return out


def mgtpu_child() -> None:
    """A process of the MGTPU_* test: join the group the variables name and
    print initialize_multihost's keys as one JSON line."""
    import json

    from multilevel_gnn_tpu_torch.parallel import multihost
    from multilevel_gnn_tpu_torch.parallel.scaling import maybe_init_multihost

    pid = maybe_init_multihost("gloo")
    info = multihost.initialize_multihost()
    mesh = multihost.global_mesh(2)
    print(json.dumps({"pid": pid, **info, "mesh": list(mesh.shape.values())}), flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    mgtpu_child()
