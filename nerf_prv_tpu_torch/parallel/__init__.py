"""Device mesh, object-axis sharding and the tp-sharded voxel field (the port of ``parallel/``)."""

from .mesh import Mesh, make_mesh, pad_to_multiple, shard_batch, shard_rows, tp_gather_rows, tp_voxel_field

__all__ = ["Mesh", "make_mesh", "pad_to_multiple", "shard_batch", "shard_rows", "tp_gather_rows", "tp_voxel_field"]
