"""Typed experiment configuration.

Replaces the reference's ~230-flag argparse + YAML-overwrites-CLI scheme
(reference opt.py:10-444) with a single typed dataclass tree.  Field names
and defaults mirror opt.py so the three shipped cohort YAMLs
(config/gbm.yaml, kirc.yaml, lgg.yaml) load unchanged and mean the same
thing.  Unlike the reference, unknown YAML keys raise, and bool flags are
real bools (opt.py's ``type=bool`` CLI flags are truthy-string broken —
documented quirk, not preserved).

Port copy of multilevel_gnn_tpu/core/config.py: the same fields and
defaults, so the shipped YAMLs load into either package.  A GPU host may
have no PyYAML, so from_yaml reads the flat ``key: value`` files the
configs are with ``read_flat_yaml``, which resolves scalars as PyYAML's
safe loader does (YAML 1.1) and raises on anything nested.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import List, Optional

# PyYAML's implicit resolvers (YAML 1.1) for the scalars a config holds
_BOOL = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")


def _scalar(text: str):
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "\"'":
        return t[1:-1]
    if t in ("", "~", "null", "Null", "NULL"):
        return None
    if t.lower() in _BOOL and t in (t.lower(), t.capitalize(), t.upper()):
        return _BOOL[t.lower()]
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t) and t not in (".", "+.", "-."):
        return float(t.replace("_", ""))
    if t.lower() in (".inf", "+.inf", "-.inf"):
        return float(t.replace(".", ""))
    if t.lower() == ".nan":
        return float("nan")
    return t


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def read_flat_yaml(text: str) -> dict:
    """A flat YAML mapping of scalars and one-line [a, b] lists."""
    out = {}
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        if line[0] in " \t-" or ":" not in line:
            raise ValueError(f"line {n}: only flat 'key: value' lines are read: {raw!r}")
        key, _, value = line.partition(":")
        value = value.strip()
        if value.startswith("[") and value.endswith("]"):
            inner = value[1:-1].strip()
            out[key.strip()] = [_scalar(v) for v in inner.split(",")] if inner else []
        elif value.startswith(("{", "[", "&", "*", "|", ">", "!")):
            raise ValueError(f"line {n}: unsupported YAML value {value!r}")
        else:
            out[key.strip()] = _scalar(value)
    return out


@dataclass
class Config:
    # ---- paths / dataset identity (opt.py:13-97)
    cancer_type: str = "gbm"
    data_dir: str = "./data"
    # Explicit reference-style per-file paths (opt.py:19-62).  Like the
    # reference (train.py:233-234), '{}' placeholders are formatted with
    # cancer_type; when --data-dir is also given, a leading './data/' (the
    # reference's repo-relative data root) is re-rooted there.  Unset
    # fields resolve under data_dir by filename convention — ours first,
    # then the reference download's default names (train/cli.py:
    # _resolve_data_paths), so a reference checkout's data directory
    # works without renaming anything.
    raw_mrna_path: Optional[str] = None
    raw_cnv_path: Optional[str] = None
    raw_methylation_path: Optional[str] = None
    clinical_path: Optional[str] = None
    node_path: Optional[str] = None
    edge_path: Optional[str] = None
    grn_edge_path: Optional[str] = None
    kegg_path: Optional[str] = None
    pathway_path: Optional[str] = None
    pathway_num: int = 146
    risk_threshold: int = 24
    use_column: Optional[str] = None
    pathway_global_node: bool = False

    # ---- dataset options (opt.py:100-123)
    soft_label: bool = False
    edge_type: str = "grnboost2"  # ppi | grnboost2 | merge
    bidir_edge: bool = False
    mute_edge: str = ""
    z_score: bool = False
    z_mean: bool = False
    zscore_mrna: bool = False
    reverse_mt: bool = False
    reverse_mt_attr: bool = False
    add_hat: bool = False
    add_hat_sigma: float = 3.0
    add_hat_percent: float = 0.99
    mul_attr: bool = False
    neighborhood: int = 0
    grn_edge_select_threshold: Optional[float] = None
    random_variation_aug: bool = False
    random_mask_aug: bool = False
    random_range: float = 0.05
    random_variation_prob: float = 0.5
    align_data: bool = False
    lag_pca: bool = False
    drop_na_percent: float = 0.9

    # ---- model (opt.py:125-297)
    model: str = "deepergcn"
    num_layers: int = 3
    mlp_layers: int = 2
    hidden_channels: int = 128
    final_channels: int = 1
    final_head: int = 1
    block: str = "res+"  # res+ | res | dense | plain
    conv: str = "gen"
    gcn_aggr: str = "max"
    norm: str = "layer"
    num_tasks: int = 2
    t: float = 1.0
    p: float = 1.0
    y: float = 0.0
    learn_t: bool = False
    learn_p: bool = False
    learn_y: bool = False
    msg_norm: bool = False
    learn_msg_scale: bool = False
    conv_encode_edge: bool = False
    graph_pooling: str = "mean"
    node_embedding: bool = False
    node_num: int = 5135
    omics_num: int = 3
    used_omics: str = "012"
    node_embedding_dim: int = 32
    num_layer_head: int = 1
    use_age: bool = False
    head_dropout: bool = False
    # DeeperGCN inter-layer gating (reference deepergcn.py:236-278): skip
    # the norm / dropout between res+ and plain blocks' layers
    no_inter_drop: bool = False
    no_inter_norm: bool = False
    # DeeperGCN weight re-init (reference deepergcn.py:169-175,351-358):
    # all_init xavier-re-inits every Linear weight + zeroes every bias;
    # head_init does the same for the prediction head only.  all_init
    # defaults TRUE like the reference (opt.py:191 `type=bool, default=True`
    # — argparse's bool('False')==True quirk means it is effectively always
    # on there).
    all_init: bool = True
    head_init: bool = False
    # MultilevelGNNSeq head: predict from the first two PCA columns only
    # (reference multilevel_gnn_seq.py:36,61-64 — the `x[:,:,:,:2]` slice
    # assumes pca_dim==2, preserved; see docs/PARITY.md)
    only_mrna_pred: bool = False
    # filter STRING/GRN edges to same-pathway gene pairs at load time
    # (reference multiloader.py:209,264 via in_same_pathway :363-371,
    # including its positional-index membership quirk)
    pretain_only_pathway_edge: bool = False
    # the flagship head's dropout is HARDCODED 0.5 in the reference
    # (multilevel_gnn.py:116,125); parameterized here (default = reference)
    # so deterministic parity tests can zero it on both sides
    head_drop_rate: float = 0.5
    use_edge_attr: bool = False
    pathway_readout: str = "maxpool"
    gnn_encoder: str = "linear"
    pca_only: bool = False
    pca_compare: bool = False
    pre_readout_drop: bool = False
    pre_concat_age: bool = False
    bi_global_node: bool = False
    global_edge: Optional[str] = "onehot"
    init_emb: bool = False
    feature_drop: bool = False
    pca_prelinear: bool = False
    more_conv: bool = False
    pathcnn_kernel_size: int = 3
    learnable_pca: bool = False
    init_with_pca: bool = False
    pca_loss: bool = False
    pca_loss_coef: float = 1.0
    pca_indep_loss: bool = False
    pca_init_type: Optional[str] = None
    pca_sim_dim: int = 5
    pca_dim: int = 2
    pca_pool_dim: int = 2
    mutual_info_mask: bool = False
    mutual_info_threshold: Optional[float] = None
    mutual_info_pca: bool = False
    pathway_pool_dim: int = 4
    step: int = 0
    gamma: float = 0.25
    gnn_pathcnn: bool = False
    freeze_pca_weight: bool = False
    value_att_mask: bool = False
    edge_select: bool = False
    edge_select_threshold: float = 1.0
    node_select_threshold: float = 1.0
    mutual_neighbors: int = 3
    mutual_classif: bool = False
    drop_irr_pathway: bool = False
    mean_pca_init: bool = False
    pca_mean_value: float = 0.006
    random_state: int = 1
    freeze_node_embedding: bool = False
    freeze_mutual_select_init: bool = False
    knn_mutual_info: bool = False
    seed: int = 1
    split_seed: int = 1
    split_shaffle: bool = False  # (sic) reference spelling, kept for YAML compat
    class_sample: bool = False
    weighted_loss: bool = False
    batch_weighted_loss: bool = False
    head_dim: int = 64
    gnn_name: str = "gat"
    dense_gnn: bool = False
    resgnn: bool = False
    pca_match_mask: bool = False
    construct_cnv_mrna_edge: bool = False
    construct_mt_mrna_edge: bool = False
    construct_mrna_cnv_edge: bool = False
    construct_mrna_mt_edge: bool = False
    weighted_edge: bool = False
    gnn_act: str = "leakyrelu"
    remain_all_tf: bool = False
    remain_tf_nums: str = "012"
    reorder_pathway: bool = False
    reorder_type: str = "pca"
    pathway_similarity: str = "correlation"
    precise_order: bool = False
    selected_similarity: bool = False
    gnn_last_norm: bool = False
    gnn_mlp_norm: str = "none"
    merge_mode: str = "mult"
    add_coef1: float = 0.5
    add_coef2: float = 0.5
    repeat_mask: bool = False
    repeat_cyclic: int = 2
    repeat_norm: bool = False
    conv_channel_list: List[int] = field(default_factory=lambda: [32, 64])
    conv_kernel_list: List[int] = field(default_factory=lambda: [1, 1])
    embedding_init_type: str = "xavier"
    emb_val: float = 0.01
    input_drop: Optional[float] = None
    input_emb_drop: Optional[float] = None

    # ---- train (opt.py:299-368)
    epochs: int = 200
    batch_size: int = 4
    optimizer: str = "adam"
    lr: float = 1e-4
    wd: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    weight_balance: bool = False
    weight_power: float = 1.0
    clip_grad: bool = False
    dropout: float = 0.5
    gnn_dropout: float = 0.0
    num_run: int = 1
    metrics: str = "auc"
    device_num: int = 1
    debug: bool = False
    save_dir: str = ""
    save_tag: str = ""
    model_save_path: str = "./checkpoint"
    use_cache: bool = False

    # ---- AE / VAE (opt.py:370-408)
    decoder_dim: int = 4096
    decoder_type: str = "flatten"
    load_autoencoder_ckpt: bool = False
    autoencoder_ckpt_path: str = ""
    warmup_epochs: int = 0
    warmup_lr: float = 5e-5
    channel_one: bool = False
    vae_generate_train_sample: bool = False
    reconstruct_head: bool = False
    allow_no_edge_pretrain: bool = False
    train_with_vae_loss: bool = False
    pretrain_std_loss: bool = False
    pretrain_std_coef: float = 1.0
    pretrain_idp_loss: bool = False
    pretrain_idp_coef: float = 1.0
    pretrain_corr_loss: bool = False
    pretrain_corr_coef: float = 1.0
    kl_beta: float = 1.0
    std_weight: bool = False
    grad_weight: bool = False
    mmd_kernel_type: str = "imq"
    mmd_alpha: float = -9.0
    mmd_beta: float = 10.5
    kld_weight: float = 0.2
    mmd_reg_weight: float = 110.0
    z_var: float = 2.0
    std_weight_coef: float = 1.0
    grad_weight_coef: float = 1.0

    # ---- VQ-VAE (opt.py:410-413)
    vqvae_num_embeddings: int = 512
    vqvae_beta: float = 0.25

    # ---- DiffPool (opt.py:415-421)
    diff_pooling_location: str = "pathway"
    diff_pooling_layer: int = 2
    diff_pooling_hidden_dim: int = 32
    diff_pooling_output_dim: int = 64
    after_pooling_layer: int = 1
    pooling_type: str = "correlation"

    # ---- reduction (opt.py:428-430)
    reduction_method: str = "linear_projection"
    pca_lowrank_niter: int = 2

    # ---- framework-only knobs (new; no reference analog).  The JAX
    # package's meaning is kept; the port reads kernel_backend, spmm_bf16,
    # windowed_spmm and compute_dtype and ignores the TPU/mesh-only ones.
    slot_sizes: Optional[tuple] = None  # genes per pathway-omics slot (AE)
    kernel_backend: str = "xla"  # xla | pallas
    spmm_bf16: bool = False  # cast SpMM data to bf16 (f32 accumulate)
    # windowed (locality-blocked) SpMM when the fold graph is
    # community-local; not attached when < 50% of edges fit windows
    windowed_spmm: bool = False
    # windowed-SpMM engagement floor on the real fold edge count
    windowed_min_edges: int = 100_000
    # mixed precision: GNN trunk in bfloat16, float32 params/head/losses.
    # None/float32 = full f32.
    compute_dtype: Optional[str] = None  # None | 'bfloat16'
    mesh_data_axis: int = 1  # data-parallel mesh size
    mesh_model_axis: int = 1  # edge-partition mesh size
    halo_exchange: bool = False  # boundary-only halo exchange (mesh runs)
    native_mi: bool = True  # threaded C++ kNN MI for the fold feature masks
    ckpt_every: int = 0  # checkpoint cadence in epochs (0 = fold boundary)
    fold_prefetch: bool = True  # overlap next fold's host derivation
    ckpt_keep: int = 0  # retain only the newest N complete checkpoints (0=all)
    epoch_scan: bool = True  # one device dispatch per epoch (JAX driver)
    fold_scan: bool = True  # one device dispatch per fold (JAX driver)
    pathway_edge_num: int = 0  # set by the data pipeline (onehot edge count)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_yaml(path: str, **overrides) -> "Config":
        with open(path) as f:
            data = read_flat_yaml(f.read())
        return Config.from_dict({**data, **overrides})

    @staticmethod
    def from_dict(data: dict) -> "Config":
        names = {f.name for f in dataclasses.fields(Config)}
        # keys present in reference YAMLs that the new pipeline does not need
        ignored = {
            "device", "num_workers", "use_gpu", "name_pre", "time", "config",
            "position_embedding", "add_hat",
            "first_conv_channel", "hidden_head",
            "pca_all", "set_all_seed", "freeze_dataloader_init",
            "freeze_net_params_init", "active_learning", "active_type",
            "active_percent", "save_method", "ckpt_path", "igscore_epoch",
            "autoencoder_save_path", "autoencoder_save_dir",
            "load_autoencoder_epoch",
        }
        # make_graph (reference multiloader.py:963) filters nodes PER
        # PATIENT by whether any neighbor's <make_graph>-omics value is
        # nonzero — per-patient topology is incompatible with this
        # framework's static shared fold graph (SURVEY §3.2 batching
        # design).  Reject loudly instead of silently diverging; the
        # reference default is None and no shipped config sets it
        # (docs/PARITY.md divergence list).
        if data.get("make_graph") is not None:
            raise NotImplementedError(
                "make_graph per-patient node filtering is not supported: "
                "it produces patient-dependent graph topology, which this "
                "framework's static-shape batched design intentionally "
                "does not model (see docs/PARITY.md)"
            )
        ignored = ignored | {"make_graph"}
        unknown = set(data) - names - ignored
        if unknown:
            raise KeyError(f"unknown config keys: {sorted(unknown)}")
        kw = {k: v for k, v in data.items() if k in names}
        cfg = Config(**kw)
        if cfg.only_mrna_pred and cfg.model != "multilevel_gnn_seq":
            raise ValueError(
                "only_mrna_pred is a MultilevelGNNSeq head flag "
                "(reference multilevel_gnn_seq.py:36); set model: "
                "multilevel_gnn_seq"
            )
        return cfg
