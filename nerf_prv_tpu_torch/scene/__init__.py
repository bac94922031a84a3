"""Scene IO of the port (so far: PLY point clouds)."""
