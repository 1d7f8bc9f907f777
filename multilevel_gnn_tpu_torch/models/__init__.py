"""Model registry (port of multilevel_gnn_tpu/models/__init__.py:5-27) for
the models the port has."""


def get_model(name: str):
    """The model class of a config's ``model`` name."""
    from multilevel_gnn_tpu_torch.models.deepergcn import DeeperGCN
    from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN

    registry = {
        "multilevel_gnn": MultilevelGNN,
        # MultilevelGNNSeq: the same model, with the only_mrna_pred head
        "multilevel_gnn_seq": MultilevelGNN,
        "deepergcn": DeeperGCN,
    }
    if name not in registry:
        raise NotImplementedError(f"model {name!r} is not ported (ported: {sorted(registry)})")
    return registry[name]
