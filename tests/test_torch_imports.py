"""Import hygiene and the device rule of the PyTorch port.

- Every module of multilevel_gnn_tpu_torch, and chip_smoke.py's imports,
  load in a fresh interpreter where ``jax`` and ``multilevel_gnn_tpu`` are
  blocked (sys.modules entries set to None, so any import of them raises).
- An entry point called without a device on a machine without CUDA raises
  instead of running on the CPU (torch.cuda.is_available is patched to
  False, so the check holds on any machine).
- Sources for the CUDA kernels are in the package, and no module builds
  them at import.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_BLOCKED = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "multilevel_gnn_tpu"):
    sys.modules[name] = None
import importlib, pkgutil
import multilevel_gnn_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
from multilevel_gnn_tpu_torch.ops.kernels import build
assert all(k._fn is None for k in build.REGISTRY.values()), "built at import"
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "multilevel_gnn_tpu")
          and sys.modules[m] is not None]
assert not leaked, leaked
print(len(names), "modules")
"""


def test_port_imports_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[0]) >= 20


def test_entry_points_default_to_cuda(monkeypatch):
    from multilevel_gnn_tpu_torch.core.device import resolve_device
    from multilevel_gnn_tpu_torch.data.synthetic import make_gbm_scale_setup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_gbm_scale_setup(node_num=50, n_pathways=4, n_edges=200, batch=2,
                             gene_rows=40)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_kernel_sources_shipped():
    from multilevel_gnn_tpu_torch.ops.kernels import build
    from multilevel_gnn_tpu_torch.ops.kernels import segment_max, segment_sum, windowed  # noqa

    assert set(build.REGISTRY) == {
        "segment_spmm_csr", "windowed_tile_spmm", "segment_max_csr"}
    for k in build.REGISTRY.values():
        assert k.source.is_file(), k.source
        text = k.source.read_text()
        assert 'extern "C" int ' + k.symbol in text
        assert k.replaces.split(":")[0] in text
        assert (REPO / k.replaces.split(":")[0]).is_file()
