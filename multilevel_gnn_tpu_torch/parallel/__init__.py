"""The ('data', 'model') mesh over torch.distributed (port of
multilevel_gnn_tpu/parallel/): parallel/comm.py's collectives, mesh.py's
mesh, sharding and data-parallel forward (train/step.py's train_step and
eval_step take a mesh), edge_partition.py's edge-shard aggregation,
halo.py's boundary-only exchange, multihost.py's process group and
scaling.py's bench."""
from multilevel_gnn_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    maybe_make_mesh,
    replicate,
    shard_batch,
    shard_ctx,
)
from multilevel_gnn_tpu_torch.parallel.halo import (  # noqa: F401
    HaloPartition,
    build_halo_partition,
    halo_gather_scatter,
)
