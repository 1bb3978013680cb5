from eesen_tpu_torch.parallel.mesh import Mesh, MeshConfig, make_mesh
from eesen_tpu_torch.parallel.sharding import (
    leaf_pspec,
    tree_pspecs,
    batch_pspec,
    shard_params,
    shard_state,
    shard_batch,
    gather_params,
)

__all__ = [
    "Mesh",
    "MeshConfig",
    "make_mesh",
    "leaf_pspec",
    "tree_pspecs",
    "batch_pspec",
    "shard_params",
    "shard_state",
    "shard_batch",
    "gather_params",
]
