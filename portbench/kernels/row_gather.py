"""``row_gather`` (E3): rows of a table gathered by index.  Its bound counts
the launch's distinct rows, so a launch keeps its indices."""

MODULE = "nerf_prv_tpu_torch.ops.row_gather"
KERNEL = "row_gather_kernel"
MEMSET_BEFORE = False


def record(args: dict, i: int) -> dict:
    t = args["table"]
    return dict(n=args["idx"].shape[0], idx=args["idx"], row_bytes=t.shape[1] * t.element_size())
