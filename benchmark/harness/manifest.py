"""BENCHMARK.json and the files it names, found by name: a configuration
in configs/<name>.json (and its plain reference configs/<reference>.py),
a traffic mix in traffic/<name>.json, a metric's reader in
metrics/<name>.py, a cell's correctness limits in limits/<cell>.json."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _module(path: Path) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """root: the checkout (BENCHMARK.json and the files under benchmark/);
    a test gives a directory of its own, whose files are looked up before
    the checkout's."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cells = {w["name"]: w for w in self.doc["workloads"]}

    def _find(self, kind: str, file: str) -> Path:
        for base in (self.root / "benchmark", BENCH):
            if (base / kind / file).is_file():
                return base / kind / file
        raise FileNotFoundError(f"benchmark/{kind}/{file}")

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return self.cells[name]

    def config(self, name: str) -> dict:
        entry = next(c for c in self.doc["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads(self._find("traffic", f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads(self._find("limits", f"{cell}.json").read_text())

    def reference(self, name: str) -> ModuleType:
        return _module(self._find("configs", f"{name}.py"))

    def reader(self, metric: str) -> ModuleType:
        return _module(self._find("metrics", f"{metric}.py"))

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (trace off) or per-layer metrics
        (trace on): those that list the cell, or list no cells."""
        group = self.doc["per_layer"] if trace else self.doc["end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def readers(self, cell: str, trace: bool) -> Dict[str, ModuleType]:
        return {m["name"]: self.reader(m["name"]) for m in self.metrics(cell, trace)}
