"""Warm a cold host before an experiment (counterpart of
multilevel_gnn_tpu/train/warm.py).

The JAX package's cold cost is XLA's compiles, which its warm tool fills
the persistent compilation cache with.  The port compiles no graph; its
cold cost is three builds, each kept for the next process:

- the nvcc builds of the CUDA kernels (ops/kernels/build.py:build_all,
  into ops/kernels/_build/, keyed by a hash of source and flags);
- the g++ builds of the data libraries, data/csrc/mi_knn.cc and
  csv_float.cc (data/native.py, into data/_build/);
- fold 0's host-side derivation (MI mask, PCA seeds, edges, the kernels'
  plans), which the cohort keeps for this process (its MI mask cache), and
  which the on-disk preprocessing cache keeps for the next when the config
  sets use_cache.

``warm_experiment`` does all three without a training step.

    python -m multilevel_gnn_tpu_torch.train.warm --config configs/gbm.yaml \\
        [--data-dir DIR | --synthetic] [--set key=value ...] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np


def warm_builds(device) -> Dict[str, float]:
    """Build (if needed) and load the kernels (on a CUDA device) and the
    data libraries; {name: seconds its build took, 0.0 when found built}.
    The g++ builds run beside the nvcc ones."""
    import torch

    from multilevel_gnn_tpu_torch.data import native

    if torch.device(device).type != "cuda":
        return native.build_libraries()
    from multilevel_gnn_tpu_torch.ops.kernels import build, import_all

    import_all()  # the kernels' modules register them
    with ThreadPoolExecutor(1) as pool:
        libraries = pool.submit(native.build_libraries)
        builds = build.build_all()
        builds.update(libraries.result())
    return builds


def warm_experiment(cfg, cohort, device="cuda") -> Dict:
    """The builds of warm_builds, then fold 0's derivation on ``device``;
    returns {"warm_s": wall seconds, "builds": {name: seconds}} with
    "fold0" the derivation's seconds."""
    from multilevel_gnn_tpu_torch.core.device import resolve_device
    from multilevel_gnn_tpu_torch.train.driver import fold_indices, fold_setup

    dev = resolve_device(device)
    t0 = time.perf_counter()
    builds = warm_builds(dev)
    t1 = time.perf_counter()
    train_idx, _, _ = fold_indices(cohort.labels(), cfg, 0)
    fold_setup(cfg, cohort, np.asarray(train_idx), 0, dev)
    builds["fold0"] = time.perf_counter() - t1
    return {"warm_s": time.perf_counter() - t0, "builds": builds}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(
        description="build the kernels and data libraries and derive fold 0 "
        "(no training step is run)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--synthetic", action="store_true",
                    help="warm against a synthetic cohort (as the train CLI)")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--set", nargs="*", default=[], help="key=value overrides")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from multilevel_gnn_tpu_torch.core.config import Config
    from multilevel_gnn_tpu_torch.core.device import resolve_device
    from multilevel_gnn_tpu_torch.train.cli import make_cohort, parse_overrides

    device = resolve_device(args.device)
    cfg = Config.from_yaml(args.config, **parse_overrides(args.set))
    if args.debug:
        cfg = cfg.replace(num_run=1, epochs=5, batch_size=8)
    cohort = make_cohort(cfg, args.synthetic, args.data_dir, args.debug)
    out = warm_experiment(cfg, cohort, device)
    print(json.dumps(out), flush=True)
    return out


def script() -> None:
    """The mgtpu-torch-warm console script: main() with sys.argv, its
    return value dropped (sys.exit would report a dict as an error)."""
    main()


if __name__ == "__main__":
    main()
