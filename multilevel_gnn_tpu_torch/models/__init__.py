"""Model registry (port of multilevel_gnn_tpu/models/__init__.py:5-27).
MiNet stays outside it, as in JAX: use models.minet.OmicsNet directly."""


def get_model(name: str):
    """The model class of a config's ``model`` name."""
    from multilevel_gnn_tpu_torch.models.autoencoder import AutoEncoder
    from multilevel_gnn_tpu_torch.models.deepergcn import DeeperGCN
    from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
    from multilevel_gnn_tpu_torch.models.multiomix import MultiOmixGCN
    from multilevel_gnn_tpu_torch.models.pathcnn import PathCNN
    from multilevel_gnn_tpu_torch.models.vae import VAE, VAEClassifier
    from multilevel_gnn_tpu_torch.models.vq_vae import VQVAE

    registry = {
        "multilevel_gnn": MultilevelGNN,
        "vae_finetune": VAEClassifier,
        # MultilevelGNNSeq: the same model, with the only_mrna_pred head
        "multilevel_gnn_seq": MultilevelGNN,
        "pathcnn": PathCNN,
        "deepergcn": DeeperGCN,
        "multiomix": MultiOmixGCN,
        "mulitomix_gcn": MultiOmixGCN,
        "multiomix_gcn": MultiOmixGCN,
        "autoencoder": AutoEncoder,
        "vae": VAE,
        "mmd_vae": VAE,
        "vq_vae": VQVAE,
    }
    if name not in registry:
        raise NotImplementedError(f"model {name!r} is not known (models: {sorted(registry)})")
    return registry[name]


def refuse_unsupported(model, what: str) -> None:
    """Raise as the JAX package's ``what`` (export, explain) fails for a
    model whose forward a batch of x and age cannot drive: PathCNN
    (batch.raw_data is None: TypeError or AttributeError) and
    VAEClassifier (three outputs where two are unpacked: ValueError).
    MultilevelGNN and DeeperGCN pass; DeeperGCN's export then fails in
    its forward, which unpacks a 3-D x (ValueError), and its explain CLI
    in pathway_attributions (IndexError), as JAX's do."""
    name = model.cfg.model
    if name == "pathcnn":
        raise TypeError(f"{what} of model 'pathcnn': its forward reads batch.raw_data, "
                        "which a batch of x and age does not carry")
    if name == "vae_finetune":
        raise ValueError(f"{what} of model 'vae_finetune': its forward returns three "
                         "outputs, where two are unpacked")
