"""Model registry (port of multilevel_gnn_tpu/models/__init__.py:5-27) for
the models the port has."""

_NOT_PORTED = ("multiomix", "mulitomix_gcn", "multiomix_gcn")


def get_model(name: str):
    """The model class of a config's ``model`` name."""
    from multilevel_gnn_tpu_torch.models.autoencoder import AutoEncoder
    from multilevel_gnn_tpu_torch.models.deepergcn import DeeperGCN
    from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
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
        "autoencoder": AutoEncoder,
        "vae": VAE,
        "mmd_vae": VAE,
        "vq_vae": VQVAE,
    }
    if name not in registry:
        raise NotImplementedError(
            f"model {name!r} is not ported (ported: {sorted(registry)}; "
            f"not yet: {', '.join(_NOT_PORTED)})")
    return registry[name]


def require_multilevel_gnn(model, what: str) -> None:
    """Refuse ``what`` (export, explain) of a model other than
    MultilevelGNN.  The JAX package's export and explain call a model on a
    batch of x and age and unpack two outputs, and fail for PathCNN
    (batch.raw_data is None: TypeError or AttributeError) and for
    VAEClassifier (three outputs: ValueError); the port raises those
    kinds, and NotImplementedError for the models it has not ported these
    for (DeeperGCN)."""
    from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN

    name = model.cfg.model
    if name == "pathcnn":
        raise TypeError(f"{what} of model 'pathcnn': its forward reads batch.raw_data, "
                        "which a batch of x and age does not carry")
    if name == "vae_finetune":
        raise ValueError(f"{what} of model 'vae_finetune': its forward returns three "
                         "outputs, where two are unpacked")
    if type(model) is not MultilevelGNN:
        raise NotImplementedError(f"{what} of model {name!r} is not ported")
