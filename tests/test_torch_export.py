"""Exported inference (train/export.py, artifact.py), port against the JAX
package's train/export.py on the CPU, mirroring tests/test_export.py.

- The port's artifact, loaded in a fresh process, against JAX's
  export_fold -> load_exported with the same params (JAX's init through
  interop.py): f32 within 1e-5; the bf16 trunk with the windowed plan
  against JAX's bf16 trunk on the 'pallas' path, within 1e-5.  In that
  process the loader has imported no module of the port's models, nn,
  data or train packages.
- The exported graph calls the kernels as mgtpu ops and holds the fold
  context as buffers, and the artifact equals the live eval_step.
- The export CLI end to end after the train CLI's checkpoints.
"""
import json
import subprocess
import sys
from pathlib import Path

import flax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.data.synthetic import make_synthetic_cohort as j_make_cohort
from multilevel_gnn_tpu.ops import spmm as jspmm
from multilevel_gnn_tpu.train import export as jexport
from multilevel_gnn_tpu.train.predict import load_fold_state as j_load_fold_state
from multilevel_gnn_tpu_torch.core.batch import Batch
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.data.synthetic import make_synthetic_cohort
from multilevel_gnn_tpu_torch.interop import state_dict_from_flax
from multilevel_gnn_tpu_torch.train import cli, export
from multilevel_gnn_tpu_torch.train.step import eval_step
from torch_threads import child_env, few_threads  # noqa: F401  (few_threads: autouse)

REPO = Path(__file__).resolve().parents[1]
GBM = str(REPO / "configs" / "gbm.yaml")
KW = dict(num_run=1, epochs=2, batch_size=8, node_embedding_dim=4, hidden_channels=8,
          final_channels=4, head_dim=16, conv_channel_list=[8, 16], compute_dtype=None,
          spmm_bf16=False, windowed_spmm=False)
BF16 = dict(KW, compute_dtype="bfloat16", spmm_bf16=True, windowed_spmm=True,
            windowed_min_edges=1)
TOL = 1e-5

_LOAD = r"""
import json, sys
import numpy as np
from multilevel_gnn_tpu_torch.artifact import load_exported
infer = load_exported(sys.argv[1])
z = np.load(sys.argv[2])
probs = infer(z["x"], z["age"])
port = [m for m in sys.modules if m.startswith("multilevel_gnn_tpu_torch.")
        and m.split(".")[1] in ("models", "nn", "data", "train")]
print(json.dumps({"probs": probs.tolist(), "meta": infer.meta, "port_modules": port}))
"""


def load_in_fresh_process(out_dir, x, age, tmp_path):
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, x=x, age=age)
    env = child_env()
    r = subprocess.run([sys.executable, "-c", _LOAD, out_dir, inputs], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def export_pair(tmp_path, kw):
    """(the port's artifact loaded in a fresh process: probs, meta, port
    modules; JAX's exported probabilities on the same batch; JAX's meta)."""
    bf16 = kw["compute_dtype"] is not None
    jcfg, cfg = JConfig.from_yaml(GBM, **kw), Config.from_yaml(GBM, **kw)
    jcohort = j_make_cohort(jcfg, seed=3, n_patients=50, n_pathways=5)
    cohort = make_synthetic_cohort(cfg, seed=3, n_patients=50, n_pathways=5)
    B = cfg.batch_size
    if bf16:
        jspmm.set_backend("pallas")
        jspmm.set_spmm_dtype(jnp.bfloat16)
    try:
        st = j_load_fold_state(jcfg, jcohort, None)  # PRNGKey(0) params
        assert (st["ctx"].graph.winplan is not None) == bf16
        jex = jexport.export_fold(jcfg, jcohort, None, params=st["params"])
        jexport.save_exported(str(tmp_path / "jax"), jex)
        jinfer = jexport.load_exported(str(tmp_path / "jax"))
        X = np.asarray(st["X"])
        idx = np.arange(B)
        x, age = X[idx], np.asarray(jcohort.ages)[idx]
        want = np.asarray(jinfer(x, age))
    finally:
        jspmm.set_backend("xla")
        jspmm.set_spmm_dtype(None)
    flat = {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(st["params"], sep="/").items()}
    ex = export.export_fold(cfg, cohort, None, params=state_dict_from_flax(flat),
                            device="cpu")
    assert (ex["state"]["ctx"].graph.winplan is not None) == bf16
    out = str(tmp_path / "port")
    export.save_exported(out, ex)
    return load_in_fresh_process(out, x, age, tmp_path), want, jex["meta"], X.shape[1]


@pytest.mark.parametrize("kw", [KW, BF16], ids=["f32", "bf16_windowed"])
def test_artifact_in_fresh_process_matches_jax_export(tmp_path, kw):
    got, want, jmeta, n_nodes = export_pair(tmp_path, kw)
    B = kw["batch_size"]
    assert got["port_modules"] == []
    assert got["meta"]["batch_size"] == B and got["meta"]["n_nodes"] == n_nodes
    assert got["meta"]["platforms"] == ["cpu"]
    for key in ("run", "fold", "cancer_type", "model"):
        assert got["meta"][key] == jmeta[key]
    probs = np.asarray(got["probs"])
    assert probs.shape == (B, 2)
    np.testing.assert_allclose(probs, want, rtol=0, atol=TOL)


def test_exported_graph_and_live_eval(tmp_path):
    cfg = Config.from_yaml(GBM, **BF16)
    cohort = make_synthetic_cohort(cfg, seed=3, n_patients=50, n_pathways=5)
    ex = export.export_fold(cfg, cohort, None, device="cpu")
    program = ex["program"]
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert "mgtpu.windowed_tile_spmm.default" in ops
    buffers = program.graph_signature.buffers
    assert any("winplan__fwd__tile_blk_ptr" in b for b in buffers)
    assert any("pca_gather__rowptr" in b for b in buffers)
    assert ex["meta"]["n_tensors"] == len(program.state_dict) + len(program.constants)
    assert not program.constants  # every context tensor is a buffer
    st = ex["state"]
    export.save_exported(str(tmp_path / "e"), ex)
    infer = export.load_exported(str(tmp_path / "e"))
    B = cfg.batch_size
    idx = np.arange(5, 5 + B)
    x, age = st["X"][idx], cohort.ages[idx]
    live, _ = eval_step(st["model"], Batch(
        x=torch.as_tensor(x), y=torch.zeros(B, 2), age=torch.as_tensor(age),
        sample_mask=torch.ones(B, dtype=torch.bool)), st["ctx"])
    assert torch.equal(infer(x, age), live)


def test_export_cli(tmp_path, capsys):
    cfgp = tmp_path / "cfg.yaml"
    cfgp.write_text(
        "cancer_type: synth\nmodel: multilevel_gnn\ngnn_name: sage\n"
        "num_run: 1\nepochs: 2\nbatch_size: 8\nsplit_shaffle: true\n"
        "split_seed: 3\nckpt_every: 2\n"
    )
    base = ["--config", str(cfgp), "--synthetic", "--debug", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ckpt")]
    small = ["node_embedding_dim=4", "hidden_channels=8", "final_channels=4", "head_dim=16",
             "conv_channel_list=[8,16]"]
    cli.main(base + ["--set", *small])
    capsys.readouterr()
    line = export.main(base + ["--out", str(tmp_path / "export"), "--set", *small])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    meta = json.loads((tmp_path / "export" / "meta.json").read_text())
    assert meta["batch_size"] == 8 and meta["cancer_type"] == "synth"
    assert (tmp_path / "export" / "model.pt2").stat().st_size > 0
    assert line["selfcheck_max_abs_diff"] == 0.0
    infer = export.load_exported(str(tmp_path / "export"))
    p = infer(np.zeros((8, meta["n_nodes"]), np.float32), np.zeros(8, np.float32))
    assert p.shape == (8, 2) and bool(torch.isfinite(p).all())
