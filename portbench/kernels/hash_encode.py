"""``hash_encode`` (K1): the multiresolution hash encode.  Its bound counts
the table rows the points read, so one launch in ``KEEP_POINTS_EVERY``
keeps its points (the roofline reader samples them); the rest keep their
count."""

MODULE = "nerf_prv_tpu_torch.ops.hash_encode"
KERNEL = "hash_encode_kernel"
MEMSET_BEFORE = False
KEEP_POINTS_EVERY = 8


def record(args: dict, i: int) -> dict:
    x = args["x"]
    return dict(n=x.shape[0], x=x if i % KEEP_POINTS_EVERY == 0 else None)
