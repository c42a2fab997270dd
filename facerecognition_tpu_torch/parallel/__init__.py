"""Multi-device layer: device meshes, the ``torch.distributed`` bootstrap,
sharded gallery search and data-parallel training's collectives.

Counterpart of ``facerecognition_tpu/parallel`` (``jax.sharding.Mesh`` and
XLA collectives there; ``torch.distributed`` groups with NCCL or gloo here).
"""

from facerecognition_tpu_torch.parallel.mesh import create_mesh, local_mesh, resolve_data_mesh
from facerecognition_tpu_torch.parallel.multihost import create_hybrid_mesh, initialize_multihost
from facerecognition_tpu_torch.parallel.sharding import (
    ShardedGallery,
    replicate,
    shard_batch,
    sharded_topk,
    sharded_topk_int8,
)

__all__ = [
    "create_hybrid_mesh",
    "create_mesh",
    "initialize_multihost",
    "local_mesh",
    "resolve_data_mesh",
    "ShardedGallery",
    "replicate",
    "shard_batch",
    "sharded_topk",
    "sharded_topk_int8",
]
