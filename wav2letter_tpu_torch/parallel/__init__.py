"""Data and tensor parallelism over ``torch.distributed`` — the port of
``wav2letter_tpu/parallel`` (see ``mesh.py`` for the grid of ranks and
``sharding.py`` for what each rank holds)."""

from .mesh import MeshSpec, make_mesh
from .sharding import replicate, shard_batch, shard_params, to_host_local

__all__ = [
    "make_mesh",
    "MeshSpec",
    "shard_batch",
    "shard_params",
    "replicate",
    "to_host_local",
]
