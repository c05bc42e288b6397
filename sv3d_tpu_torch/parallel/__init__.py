"""Multi-GPU training and inference over torch.distributed (port of
sv3d_tpu/parallel): the names of the JAX package's __all__ that have a
counterpart here, and Mesh and barrier.  The JAX package's shardings
(batch_sharding, point_sharding, replicate) have none: a rank holds its
share of a batch as a plain tensor."""

from sv3d_tpu_torch.parallel.mesh import POINT_KEYS, Mesh, make_mesh, replicate_tree, shard_batch
from sv3d_tpu_torch.parallel.multihost import (
    barrier,
    initialize_distributed,
    is_main_process,
    local_device,
    process_count,
    process_index,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate_tree",
    "initialize_distributed",
    "is_main_process",
    "process_count",
    "process_index",
    "Mesh",
    "POINT_KEYS",
    "barrier",
    "local_device",
]
