"""Train CLI of the port (counterpart of multilevel_gnn_tpu/train/cli.py):

    python -m multilevel_gnn_tpu_torch.train.cli --config configs/gbm.yaml \\
        (--data-dir DIR | --synthetic) [--set key=value ...] [--device cpu] \\
        [--ckpt-dir DIR [--resume]] [--profile-dir DIR] \\
        [--pretrain {autoencoder,vae,mmd_vae,vq_vae} [--pretrain-epochs N]]

Runs run_experiment, the num_run x 5-fold protocol, on a cohort read from
reference-format files under --data-dir (or on a generated one with
--synthetic) and prints one JSON line: the pooled AUC / ACC at the last
check epoch and the wall time.  --out writes the whole result.  The device
is CUDA unless --device cpu is given; the kernels (on CUDA) and the data
libraries are built first, and the line gives each build's seconds (0.0
for one found built, as after the warm CLI, train/warm.py).  --ckpt-dir checkpoints every fold
(at its last epoch, or every N epochs with --set ckpt_every=N) and saves
each finished fold's result; --resume continues an interrupted protocol
from there.  --profile-dir writes a torch.profiler trace of the whole
experiment (utils/profiling.py).  --pretrain first trains that
reconstruction model's encoder on the whole cohort for --pretrain-epochs
(the config's epochs by default), and every fold's model starts from it
(train/pretrain.py).  The JAX CLI's mesh, fold-parallel and scaling
options are not ported.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os

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
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--synthetic", action="store_true")
    src.add_argument("--data-dir", default=None)
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
    ap.add_argument("--set", nargs="*", default=[], help="key=value overrides")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from multilevel_gnn_tpu_torch.core.device import resolve_device
    from multilevel_gnn_tpu_torch.train.driver import run_experiment
    from multilevel_gnn_tpu_torch.train.warm import warm_builds
    from multilevel_gnn_tpu_torch.utils.profiling import trace

    device = resolve_device(args.device)
    # every kernel and data library at once, before the cohort is read
    builds = warm_builds(device)
    cfg = Config.from_yaml(args.config, **parse_overrides(args.set))
    if args.debug:
        cfg = cfg.replace(num_run=1, epochs=5, batch_size=8)
    cohort = make_cohort(cfg, args.synthetic, args.data_dir, args.debug)
    prof = trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    with prof:
        results = run_experiment(cfg, cohort, device=device, ckpt_dir=args.ckpt_dir,
                                 resume=args.resume, pretrain=args.pretrain,
                                 pretrain_epochs=args.pretrain_epochs)
    final_e = results["check_epochs"][-1]
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


if __name__ == "__main__":
    main()
