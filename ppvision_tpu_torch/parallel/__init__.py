"""Data parallelism over torch.distributed: the mesh, the batch split,
replication and the autograd-aware collectives."""

from .mesh import (  # noqa: F401
    Mesh,
    all_reduce_grads,
    all_reduce_max,
    all_reduce_mean,
    all_reduce_sum,
    current_mesh,
    initialize_multihost,
    make_mesh,
    mean_metrics,
    replicate,
    shard_batch,
)
