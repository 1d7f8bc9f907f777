"""BENCHMARK.json against the benchmark's contract, and every name it
holds resolved to its file."""
import json
import math
import re

import pytest

import tiny  # noqa: F401  (puts the harness on sys.path)
from harness.manifest import BENCH, ROOT, Manifest

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = DOC["end_to_end"] + DOC["per_layer"]


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["paths"] == ["benchmark"]
    assert DOC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= DOC["run_seconds"] <= 51
    assert len(json.dumps(DOC)) < 64 * 1024


def test_check_fits_with_24_cells():
    # 2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s a cell to
    # compile and 1,200 s spare, within 43,200 s at the full 24 cells
    cells = 24
    total = (2 + 14 * cells) * (DOC["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200


@pytest.mark.parametrize("name", [c["name"] for c in DOC["configs"]]
                         + [w["name"] for w in DOC["workloads"]]
                         + [m["name"] for m in METRICS])
def test_names(name):
    assert NAME.match(name)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    keys = {"name", "unit", "better", "source"}
    keys |= {"bound"} if metric in DOC["end_to_end"] else {"layer", "moves"}
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    if metric in DOC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
    for cell in metric.get("workloads", []):
        assert cell in {w["name"] for w in DOC["workloads"]}


@pytest.mark.parametrize("cell", DOC["workloads"], ids=lambda w: w["name"])
def test_cells_resolve(cell):
    man = Manifest()
    conf = man.config(cell["config"])
    assert conf["name"] == cell["config"]
    assert man.traffic(cell["traffic"])["kind"] in ("serve", "fold_train")
    assert man.reference(conf["reference"]).Reference
    assert set(man.limits(cell["name"]))
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    e2e = [m["name"] for m in man.metrics(cell["name"], False)]
    per_layer = man.metrics(cell["name"], True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    for m in man.readers(cell["name"], True).values():
        assert callable(m.read)


def test_per_layer_cells_report_their_moves_metric():
    man = Manifest()
    for m in DOC["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in [e["name"] for e in man.metrics(cell, False)], (m, cell)


def test_layers_named_alike():
    # metrics of one layer give it letter for letter
    by_prefix = {}
    for m in DOC["per_layer"]:
        by_prefix.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values()), by_prefix


@pytest.mark.parametrize("c", DOC["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    conf = json.loads((ROOT / c["file"]).read_text())
    assert c["file"].startswith("benchmark/") and c["source"].startswith("https://")
    assert set(c["reduced"]) <= set(conf) and len(c["reduced"]) <= 16
    # the configuration as run holds the shipped YAML's keys unchanged
    from multilevel_gnn_tpu_torch.core.config import read_flat_yaml

    shipped = read_flat_yaml((ROOT / "configs" / f"{c['name']}.yaml").read_text())
    assert {k: conf["config"][k] for k in shipped} == shipped
    assert not math.isnan(conf["fold"]["genes"])
