"""A tiny copy of the benchmark for CPU tests: the kirc and gbm
configurations at small sizes (every option as shipped), written with a
BENCHMARK.json of their own into a directory the Manifest reads first."""
from __future__ import annotations

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {"node_embedding_dim": 4, "hidden_channels": 8, "final_channels": 4,
         "head_dim": 16, "node_num": 60, "pathway_num": 8}
FOLD = {"genes": 60, "ppi_pairs": 600, "community": 12, "pathways": 8, "pca_rows": 120}
COHORT = {"patients": 40, "positives": 16}


def write(tmp: Path, batch: dict = None, limits: dict = None) -> Path:
    """tmp/BENCHMARK.json with the cells tiny-kirc-serve, tiny-gbm-serve and
    tiny-kirc-train, and their configurations, mixes and limits."""
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "benchmark" / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / "benchmark" / "traffic").mkdir(parents=True, exist_ok=True)
    (tmp / "benchmark" / "limits").mkdir(parents=True, exist_ok=True)
    configs = []
    for c in doc["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        conf["config"].update(SMALL, batch_size=(batch or {}).get(c["name"], 8))
        conf["fold"].update(FOLD)
        conf["cohort"].update(COHORT)
        name = "tiny-" + c["name"]
        f = tmp / "benchmark" / "configs" / f"{name}.json"
        f.write_text(json.dumps(conf))
        configs.append({**c, "name": name, "file": str(f.relative_to(tmp))})
    cells = []
    for w in doc["workloads"]:
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        if mix["kind"] == "serve":
            mix.update(patients=8, distinct_requests=16, check_requests=4)
        name = "tiny-" + w["name"]
        (tmp / "benchmark" / "traffic" / f"tiny-{w['traffic']}.json").write_text(
            json.dumps(mix))
        lim = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        lim.update((limits or {}).get(w["name"], {}))
        (tmp / "benchmark" / "limits" / f"{name}.json").write_text(json.dumps(lim))
        cells.append({**w, "name": name, "config": "tiny-" + w["config"],
                      "traffic": "tiny-" + w["traffic"]})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny-" + n for n in m["workloads"]]
    doc.update(configs=configs, workloads=cells)
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp


def manifest(tmp: Path, **kw):
    from harness.manifest import Manifest

    return Manifest(write(tmp, **kw))
