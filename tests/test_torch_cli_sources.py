"""The data source and resume rules of the port's five CLIs against the JAX
package's, on the CPU.

- Data source: each CLI (train, predict, explain, export, warm) accepts
  neither --synthetic nor --data-dir, and then reads the files under the
  config's data_dir (here set with --set data_dir=DIR to a cohort written
  by write_reference_format); with both, --synthetic wins.  Both packages'
  CLIs run up to their make_cohort call, whose arguments and cohort are
  recorded and the run stopped there; the two cohorts have the same
  patients and the same X.
- --resume without --ckpt-dir: both train CLIs exit 2.
- The console scripts that pyproject.toml names for the port resolve to
  callables of the port's CLI modules.
"""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest

from multilevel_gnn_tpu.train import cli as jcli
from multilevel_gnn_tpu_torch.data.synthetic import write_reference_format
from multilevel_gnn_tpu_torch.train import cli as pcli
from torch_threads import few_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
GBM = str(REPO / "configs" / "gbm.yaml")
CLIS = ("cli", "predict", "explain", "export", "warm")


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cohort"))
    write_reference_format(d, seed=3, cancer_type="gbm", n_patients=40, n_pathways=4)
    return d


def _argv(name, port, tmp):
    argv = ["--config", GBM]
    if name in ("predict", "explain", "export"):
        argv += ["--ckpt-dir", str(tmp / "ck")]
    if name == "export":
        argv += ["--out", str(tmp / "ex")]
    if port:
        argv += ["--device", "cpu"]
    return argv


def _cohort_of(cli_mod, pkg, name, argv, monkeypatch):
    """Run pkg's CLI ``name`` until its make_cohort call; returns the
    call's (synthetic, data_dir) and the cohort it made."""
    seen = {}
    real = cli_mod.make_cohort

    def spy(cfg, synthetic, data_dir=None, debug=False):
        seen["args"] = (bool(synthetic), data_dir)
        seen["cohort"] = real(cfg, synthetic, data_dir, debug)
        raise _Stop

    monkeypatch.setattr(cli_mod, "make_cohort", spy)
    main = importlib.import_module(f"{pkg}.train.{name}").main
    with pytest.raises(_Stop):
        main(argv)
    return seen["args"], seen["cohort"]


@pytest.mark.parametrize("sources", ["neither", "both"])
@pytest.mark.parametrize("name", CLIS)
def test_data_source_as_jax_reads_it(name, sources, written, tmp_path, monkeypatch):
    extra = ["--debug"]
    if sources == "both":
        extra += ["--synthetic", "--data-dir", written]
    sets = ["--set", "num_run=1"] + ([f"data_dir={written}"] if sources == "neither" else [])
    j_args, jc = _cohort_of(jcli, "multilevel_gnn_tpu", name,
                            _argv(name, False, tmp_path) + extra + sets, monkeypatch)
    p_args, pc = _cohort_of(pcli, "multilevel_gnn_tpu_torch", name,
                            _argv(name, True, tmp_path) + extra + sets, monkeypatch)
    assert p_args == j_args == ((False, None) if sources == "neither" else (True, written))
    assert pc.patients == jc.patients
    np.testing.assert_array_equal(np.asarray(pc.X), np.asarray(jc.X))


def test_resume_without_ckpt_dir_exits_2_as_in_jax(capsys):
    for main in (jcli.main, pcli.main):
        with pytest.raises(SystemExit) as e:
            main(["--config", GBM, "--synthetic", "--resume"])
        assert e.value.code == 2
        assert "--resume requires --ckpt-dir" in capsys.readouterr().err


def test_console_scripts_name_the_port_clis():
    text = (REPO / "pyproject.toml").read_text()
    found = dict(re.findall(r'^(mgtpu-torch-\w+) = "([\w.:]+)"$', text, re.M))
    assert sorted(found) == sorted(f"mgtpu-torch-{n}" for n in
                                   ("train", "predict", "explain", "export", "warm"))
    for target in found.values():
        mod, fn = target.split(":")
        assert mod.startswith("multilevel_gnn_tpu_torch.train.")
        assert callable(getattr(importlib.import_module(mod), fn))
