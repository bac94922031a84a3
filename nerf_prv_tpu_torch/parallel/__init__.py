"""Device mesh and object-axis sharding (the port of ``parallel/``)."""

from .mesh import Mesh, make_mesh, pad_to_multiple, shard_batch

__all__ = ["Mesh", "make_mesh", "pad_to_multiple", "shard_batch"]
