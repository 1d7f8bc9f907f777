"""The port's mesh (parallel/mesh.py, comm.py, multihost.py) on the CPU.

- The collectives on 4 gloo ranks of a 2 x 2 mesh: each rank's place
  (rank d*M + m at [d, m], the model group of its row, the data group of
  its column), and each Function's forward and its backward's share
  (all_gather_rows, local_block, all_to_all, from_model_region); make_mesh
  refuses a grid of more or fewer ranks than the group holds.
- One train step (train_step with a mesh) on a 2 x 2 mesh against the
  single-device train_step, with gbm.yaml's dropouts on (feature drop,
  head dropout, the SAGE MLP's 0.25): the sage model (composed and halo
  aggregation), DeeperGCN with softmax and max aggregation, vae_finetune
  with the DiffPool head (its link and entropy losses over the whole
  batch), PathCNN, gat and mr.  Loss within rtol 1e-4, the parameters
  after the step within rtol 5e-4 / atol 5e-5 (JAX's own tolerances,
  tests/test_parallel.py:86-93), each gradient within 1e-5 of its largest
  element; every rank's parameters equal rank 0's exactly.
- A 1 x 1 mesh's step equals train_step (JAX's
  test_parallel_loss_matches_shared_builder), with vae_finetune / DiffPool.
- In one process: RowShardGenerator draws the rank's rows of the whole
  batch's dropout mask, and the data-rank statistics without a shard are
  the plain ones.
- initialize_multihost from the MGTPU_* variables in two processes gives
  JAX's four keys, and global_mesh(2) a 1 x 2 mesh.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multilevel_gnn_tpu_torch.nn.basic import RowShardGenerator
from multilevel_gnn_tpu_torch.parallel import comm
from multilevel_gnn_tpu_torch.parallel import mesh as PM
from multilevel_gnn_tpu_torch.parallel.multihost import free_port
from multilevel_gnn_tpu_torch.train import step as S

import torch_parallel as TP
from torch_threads import child_env, few_threads  # noqa: F401  (autouse)

STEP_CASES = {
    "sage": {},
    "sage_halo": {"halo_exchange": True},
    "deepergcn_softmax": dict(TP.DGCN, gcn_aggr="softmax"),
    "deepergcn_max": dict(TP.DGCN, gcn_aggr="max"),
    "vae_diff_pooling": {"model": "vae_finetune", "reorder_type": "diff_pooling"},
    "pathcnn": {"model": "pathcnn"},
    "gat": {"gnn_name": "gat", "final_head": 4},
    "mr": {"gnn_name": "mr"},
}


@pytest.fixture(scope="module")
def comm_ranks():
    return TP.run_ranks(TP.comm_rank, 4)


def test_mesh_places_ranks(comm_ranks):
    for r, out in enumerate(comm_ranks):
        d, m = divmod(r, 2)
        assert out["place"] == (d, m, r)
        assert out["model_ranks"] == [2 * d, 2 * d + 1]
        assert out["data_ranks"] == [m, m + 2]


def test_mesh_refuses_other_sizes(comm_ranks):
    for out in comm_ranks:
        assert len(out["refused"]) == 2
        assert "needs 6 ranks" in out["refused"][0]
        assert "leaves 2" in out["refused"][1]


@pytest.mark.parametrize("op", ["all_gather_rows", "local_block", "all_to_all",
                                "from_model_region"])
def test_collective_adjoints(comm_ranks, op):
    """Forward values and the backward's share on each rank of the model
    groups {0, 1} and {2, 3}, cotangent share (rank + 1) * the seed."""
    for r, out in enumerate(comm_ranks):
        y, dx = out[op]
        m, base = r % 2, r - r % 2
        w = (base + 1) + (base + 2)  # the group's shares summed
        if op == "all_gather_rows":
            np.testing.assert_array_equal(y, np.repeat([base, base + 1], 2)[:, None]
                                          * np.ones((4, 3)))
            np.testing.assert_array_equal(dx, np.full((2, 3), w))
        elif op == "local_block":
            x = np.arange(8.0).reshape(4, 2)
            np.testing.assert_array_equal(y, x[2 * m:2 * m + 2])
            want = np.zeros((4, 2))
            want[2 * m:2 * m + 2] = r + 1
            np.testing.assert_array_equal(dx, want)
        elif op == "all_to_all":
            src = [np.arange(6.0).reshape(2, 3) + 10 * q for q in (base, base + 1)]
            np.testing.assert_array_equal(y, np.stack([s[m] for s in src]))
            seed = np.arange(6.0).reshape(2, 3)
            np.testing.assert_array_equal(
                dx, np.stack([seed[m] * (q + 1) for q in (base, base + 1)]))
        else:
            np.testing.assert_array_equal(y, np.full(3, float(w)))
            np.testing.assert_array_equal(dx, np.full(3, float(w)))


@pytest.fixture(scope="module")
def step_ranks():
    return TP.run_ranks(TP.step_rank, 4, 2, 2, STEP_CASES)


def _close_steps(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert got["params"].keys() == want["params"].keys()
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=5e-4, atol=5e-5, err_msg=k)
        g, gw = got["grads"][k], want["grads"][k]
        if gw is None or not np.abs(gw).max():
            assert g is None or not np.abs(g).max(), k
            continue
        assert np.abs(g - gw).max() <= 1e-5 * np.abs(gw).max(), k


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_2x2_step_matches_single_device(step_ranks, name):
    want = TP.single_step(STEP_CASES[name])
    _close_steps(step_ranks[0][name], want)
    assert all(r[name]["equal_to_rank0"] for r in step_ranks)


@pytest.mark.parametrize("name", ["sage", "vae_diff_pooling"])
def test_1x1_step_equals_train_step(name):
    """train_step on a 1 x 1 mesh is train_step, the DiffPool / VAE
    family's extra losses included."""
    kw = STEP_CASES[name]
    want = TP.single_step(kw)
    fcfg, ctx, batch, cw, seed = TP.step_setup(TP.tiny(**kw))
    model = TP._model(fcfg, ctx, seed)
    opt = S.make_optimizer(model, fcfg, 1)
    loss = S.train_step(model, opt, batch, ctx, cw, torch.Generator().manual_seed(seed),
                        PM.make_mesh(1, 1))
    got = TP._step_out(model, loss)
    assert got["loss"] == want["loss"]
    for k, v in want["params"].items():
        np.testing.assert_array_equal(got["params"][k], v, err_msg=k)


def test_mgtpu_variables_two_processes():
    port = free_port()
    helper = str(Path(TP.__file__))
    procs = [subprocess.Popen(
        [sys.executable, helper], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(child_env(), MGTPU_COORDINATOR=f"127.0.0.1:{port}",
                            MGTPU_NUM_PROC="2", MGTPU_PROC_ID=str(i)))
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    for i, o in enumerate(outs):
        assert o == {"pid": i, "process_index": i, "process_count": 2,
                     "local_devices": 1, "global_devices": 2, "mesh": [1, 2]}


@pytest.mark.parametrize("batch_axis,shape", [(0, (3, 5)), (1, (4, 3, 2)), (0, (1, 5))])
def test_row_shard_generator_keeps_the_rank_rows(batch_axis, shape):
    """Rank 1 of 2 draws the whole batch's mask and keeps its rows; a mask
    broadcast over the batch (1 row) is drawn as it is."""
    shard = comm.DataShard(None, 2, 1, shape[batch_axis])
    got = RowShardGenerator(torch.Generator().manual_seed(9), shard).rand(
        shape, batch_axis, "cpu")
    full = list(shape)
    if shape[batch_axis] > 1:
        full[batch_axis] *= 2
    want = torch.rand(full, generator=torch.Generator().manual_seed(9))
    if shape[batch_axis] > 1:
        want = want.narrow(batch_axis, shape[batch_axis], shape[batch_axis])
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        RowShardGenerator(torch.Generator(), comm.DataShard(None, 2, 0, 7)).rand(
            (3, 5), 0, "cpu")


def test_statistics_without_a_shard_are_plain():
    x = torch.randn(4, 3, 5, generator=torch.Generator().manual_seed(2))
    m, v = comm.batch_moments(x, (0, 2), None)
    assert torch.equal(m, x.mean(dim=(0, 2), keepdim=True))
    assert torch.equal(v, x.var(dim=(0, 2), unbiased=False, keepdim=True))
    one = comm.DataShard(None, 1, 0, 4)
    for shard in (None, one):
        assert comm.data_sum(x, shard) is x
        assert comm.data_gather(x, 1, shard) is x and comm.data_local(x, 1, shard) is x
