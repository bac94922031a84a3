"""``row_scatter_add`` (E1, E2, E4): update rows summed into a zeroed
output by index.  Its bound needs only the launch's sizes."""

MODULE = "nerf_prv_tpu_torch.ops.row_scatter_add"
KERNEL = "row_scatter_add_kernel"
MEMSET_BEFORE = True


def record(args: dict, i: int) -> dict:
    idx, upd = args["idx"], args["upd"]
    return dict(n=idx.shape[0], idx_bytes=idx.element_size(), width=upd.shape[1], n_rows=args["n_rows"])
