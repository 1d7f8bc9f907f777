"""Train CLI of the port (counterpart of multilevel_gnn_tpu/train/cli.py):

    python -m multilevel_gnn_tpu_torch.train.cli --config configs/gbm.yaml \\
        [--data-dir DIR | --synthetic] [--set key=value ...] [--device cpu] \\
        [--ckpt-dir DIR [--resume]] [--profile-dir DIR] \\
        [--pretrain {autoencoder,vae,mmd_vae,vq_vae} [--pretrain-epochs N]] \\
        [--fold-parallel [DEVICES]] [--mesh DxM] [--bench-scaling]

Runs run_experiment, the num_run x 5-fold protocol, on a cohort read from
reference-format files under --data-dir (or on a generated one with
--synthetic, which wins when both are given; with neither, under the
config's data_dir, as the JAX CLI reads it) and prints one JSON line: the
pooled AUC / ACC at the last check epoch and the wall time.  --out writes the whole result.  The device
is CUDA unless --device cpu is given; the kernels (on CUDA) and the data
libraries are built first, and the line gives each build's seconds (0.0
for one found built, as after the warm CLI, train/warm.py).  --ckpt-dir checkpoints every fold
(at its last epoch, or every N epochs with --set ckpt_every=N) and saves
each finished fold's result; --resume continues an interrupted protocol
from there.  --profile-dir writes a torch.profiler trace of the whole
experiment (utils/profiling.py).  --pretrain first trains that
reconstruction model's encoder on the whole cohort for --pretrain-epochs
(the config's epochs by default), and every fold's model starts from it
(train/pretrain.py).  --fold-parallel runs the protocol's units in
lockstep as one stacked step (train/fold_parallel.py), on DEVICES groups
(cuda:0 .. DEVICES-1) when given; it does not combine with --pretrain or
--mesh (exit 2, as the JAX CLI refuses them).

--mesh DxM runs the protocol on a D x M ('data', 'model') mesh of ranks
(parallel/mesh.py; --set halo_exchange=true for the halo form), one
process a rank: without the MGTPU_* variables the CLI spawns D*M ranks on
cuda:0 .. D*M-1 over NCCL (it exits with an error when the host has fewer
cards), or over gloo with --device cpu; with MGTPU_COORDINATOR (host:port
of rank 0), MGTPU_NUM_PROC and MGTPU_PROC_ID set, this process is rank
MGTPU_PROC_ID of the group, one command on every host.  Rank 0 alone
prints the line and writes --out.  --bench-scaling runs the halo scaling
bench (parallel/scaling.py) instead of training and prints its line
(JAX's keys, then the builds' seconds).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import sys

import torch

from multilevel_gnn_tpu_torch.core.config import Config

# Per-file names under data_dir: the conventional name first, then the
# reference download's default (cli.py:36-52).
_DATA_CANDIDATES = {
    "raw_mrna": ("{ct}/raw_mrna.csv", "{ct}/pathcnn_raw_mrna_pid_u133.csv"),
    "raw_cnv": ("{ct}/raw_cnv.csv", "{ct}/pathcnn_raw_cnv_pid.csv"),
    "raw_methylation": (
        "{ct}/raw_methylation.csv", "{ct}/pathcnn_raw_methylation_pid.csv"),
    "clinical": ("{ct}/clinical.pkl", "{ct}/pathcnn_clinical_data.pkl"),
    "kegg": ("kegg.csv", "kegg_52.csv"),
    "pathway": ("pathways.txt", "pathcnn_pathway_codes.pkl"),
    "node": ("node.csv", "pathcnn_node.csv"),
    "edge": ("{ct}/grn_edges.tsv", "{ct}/pyscenic_adj_nes1.0_auc0.01_weighted_l1.tsv"),
    "grn_edge": ("grn_edges.tsv", "adjacencies.csv"),
}


def parse_overrides(pairs):
    """--set key=value pairs -> dict, JSON-decoded values where possible."""
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    return overrides


def _resolve_data_paths(cfg: Config, data_dir=None):
    """The cohort's input files (cli.py:55-90).  An explicit path field
    wins: '{}' is formatted with cancer_type, and with --data-dir a leading
    './data/' is re-rooted there.  An unset field takes the first existing
    candidate name under the data directory (the conventional one when
    none exists, so the loader's error names it)."""
    d = data_dir or cfg.data_dir
    ct = cfg.cancer_type

    def resolve(key, explicit):
        if explicit:
            p = explicit.replace("{}", ct) if "{}" in explicit else explicit
            if data_dir and not os.path.isabs(p):
                for pre in ("./data/", "data/"):
                    if p.startswith(pre):
                        p = os.path.join(data_dir, p[len(pre):])
                        break
            return p
        cands = [os.path.join(d, c.format(ct=ct)) for c in _DATA_CANDIDATES[key]]
        for c in cands:
            if os.path.exists(c):
                return c
        return cands[0]

    return {
        "mrna_path": resolve("raw_mrna", cfg.raw_mrna_path),
        "cnv_path": resolve("raw_cnv", cfg.raw_cnv_path),
        "methylation_path": resolve("raw_methylation", cfg.raw_methylation_path),
        "clinical_path": resolve("clinical", cfg.clinical_path),
        "kegg_path": resolve("kegg", cfg.kegg_path),
        "pathway_list_path": resolve("pathway", cfg.pathway_path),
        "edge_path": resolve("edge", cfg.edge_path),
        "ppi_node_path": (resolve("node", cfg.node_path)
                          if cfg.edge_type in ("ppi", "merge") else None),
        "grn_edge_path": (resolve("grn_edge", cfg.grn_edge_path)
                          if cfg.edge_type == "merge" else None),
    }


def make_cohort(cfg: Config, synthetic: bool, data_dir=None, debug: bool = False):
    """The cohort of a run: generated (cli.py:112-125's sizes) or read."""
    if synthetic:
        from multilevel_gnn_tpu_torch.data.synthetic import make_synthetic_cohort

        return make_synthetic_cohort(
            cfg, seed=cfg.seed,
            n_patients=60 if debug else 200, n_pathways=6 if debug else 20,
        )
    from multilevel_gnn_tpu_torch.data.loaders import load_cohort_from_files

    return load_cohort_from_files(cfg=cfg, **_resolve_data_paths(cfg, data_dir))


def main(argv=None) -> dict:
    """Run the protocol; prints the summary line and returns the result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--debug", action="store_true", help="tiny fast settings")
    ap.add_argument("--out", default=None, help="results json path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint dir: every fold at its last epoch, or "
                         "every N epochs with --set ckpt_every=N")
    ap.add_argument("--resume", action="store_true",
                    help="resume an interrupted experiment from --ckpt-dir")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the whole experiment "
                         "into DIR (Chrome trace format)")
    ap.add_argument("--pretrain", default=None,
                    choices=["autoencoder", "vae", "mmd_vae", "vq_vae"],
                    help="reconstruction-pretrain the encoder first, then fine-tune")
    ap.add_argument("--pretrain-epochs", type=int, default=None)
    ap.add_argument("--fold-parallel", nargs="?", type=int, const=0, default=None,
                    metavar="DEVICES",
                    help="fold-parallel CV: all (run, fold) units advance as one "
                         "stacked step; an optional count splits the units into "
                         "that many groups, one a card (in turn where groups "
                         "outnumber cards)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="device mesh, e.g. 4x2 = 4-way data x 2-way edge partition")
    ap.add_argument("--bench-scaling", action="store_true",
                    help="instead of training: run the halo-aggregation scaling bench "
                         "at GBM scale over the --mesh model axis (multihost via "
                         "MGTPU_COORDINATOR/MGTPU_NUM_PROC/MGTPU_PROC_ID env); one "
                         "JSON line with edges/s/chip + efficiency + predicted wire "
                         "bytes")
    ap.add_argument("--set", nargs="*", default=[], help="key=value overrides")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import torch.distributed as dist

    from multilevel_gnn_tpu_torch.core.device import resolve_device
    from multilevel_gnn_tpu_torch.parallel.scaling import (
        maybe_init_multihost,
        run_bench_scaling,
    )
    from multilevel_gnn_tpu_torch.train.driver import run_experiment
    from multilevel_gnn_tpu_torch.train.warm import warm_builds
    from multilevel_gnn_tpu_torch.utils.profiling import trace

    cfg = Config.from_yaml(args.config, **parse_overrides(args.set))
    if args.debug:
        cfg = cfg.replace(num_run=1, epochs=5, batch_size=8)
    if args.mesh:
        d, m = (int(v) for v in args.mesh.lower().split("x"))
        cfg = cfg.replace(mesh_data_axis=d, mesh_model_axis=m)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --ckpt-dir")
    if args.fold_parallel is not None and (args.pretrain or args.mesh):
        ap.error("--fold-parallel is incompatible with --pretrain/--mesh")
    device = resolve_device(args.device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    maybe_init_multihost(backend)
    ranks = cfg.mesh_data_axis * cfg.mesh_model_axis
    if dist.is_initialized() and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    # every kernel and data library at once, before the cohort is read (and
    # before any rank is spawned, so the ranks find them built)
    builds = warm_builds(device)
    if args.bench_scaling:
        return run_bench_scaling(cfg, device=device, extra={"builds": builds})
    if ranks > 1 and not dist.is_initialized():
        if device.type == "cuda" and torch.cuda.device_count() < ranks:
            ap.error(f"--mesh {args.mesh} needs {ranks} cards; the host has "
                     f"{torch.cuda.device_count()}")
        from multilevel_gnn_tpu_torch.parallel.multihost import spawn

        return spawn(_mesh_rank, ranks, list(argv) if argv is not None else sys.argv[1:],
                     backend=backend, deadline_s=MESH_DEADLINE_S)[0]
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    cohort = make_cohort(cfg, args.synthetic, args.data_dir, args.debug)
    prof = trace(args.profile_dir) if args.profile_dir and rank0 else contextlib.nullcontext()
    with prof:
        if args.fold_parallel is not None:
            results = _fold_parallel(args, cfg, cohort, device)
        else:
            results = run_experiment(cfg, cohort, device=device, ckpt_dir=args.ckpt_dir,
                                     resume=args.resume, pretrain=args.pretrain,
                                     pretrain_epochs=args.pretrain_epochs)
    final_e = results["check_epochs"][-1]
    if not rank0:
        return results
    print(json.dumps({
        "cancer_type": cfg.cancer_type,
        "model": cfg.model,
        "pretrain": args.pretrain,
        "device": str(device),
        "pooled_auc": results["auc"][final_e],
        "pooled_auc_by_loss": results["auc_by_loss"][final_e],
        "pooled_acc": results["acc"][final_e],
        "wall_time_s": results["wall_time_s"],
        "builds": builds,
    }), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**results, "config": dataclasses.asdict(cfg)}, f, indent=2)
    return results


# a spawned mesh run's ranks must all finish within this many seconds
MESH_DEADLINE_S = 7 * 24 * 3600


def _mesh_rank(rank: int, argv) -> dict:
    """A rank of --mesh spawned by main: main(argv) inside its group."""
    return main(argv)


def _fold_parallel(args, cfg, cohort, device) -> dict:
    """run_experiment_foldparallel, with the single-device warning."""
    import torch

    from multilevel_gnn_tpu_torch.train.fold_parallel import (
        recommended_arm,
        run_experiment_foldparallel,
    )

    n_dev = args.fold_parallel or (torch.cuda.device_count() if device.type == "cuda" else 1)
    if recommended_arm(n_dev) == "sequential":
        logging.getLogger(__name__).warning(
            "--fold-parallel on one device: on an NVIDIA H100 (700 W) five "
            "GBM-scale units stepped together took 45.6-45.8 ms a step "
            "against 45.5-75.4 ms stepped in turn (no faster where the host "
            "keeps up: the stacked kernels take 9% longer), the 1-run "
            "protocol about as long as the sequential driver (the folds are "
            "derived before training, not beside it), and 150 units do not fit the "
            "card as one group (--fold-parallel 2 or more steps groups in "
            "turn); see PERF.md.  Proceeding as asked")
    return run_experiment_foldparallel(
        cfg, cohort, devices=args.fold_parallel or None, ckpt_dir=args.ckpt_dir,
        resume=args.resume, device=device)


def script() -> None:
    """The mgtpu-torch-train console script: main() with sys.argv, its
    return value dropped (sys.exit would report a dict as an error)."""
    main()


if __name__ == "__main__":
    main()
