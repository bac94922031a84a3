"""``hash_encode_backward`` (K1b): K1's table gradient, into an output its
wrapper zeroes first.  Kept as K1's launches are: the points of one launch
in ``KEEP_POINTS_EVERY``, the count of every one."""

MODULE = "nerf_prv_tpu_torch.ops.hash_encode"
KERNEL = "hash_encode_backward_kernel"
MEMSET_BEFORE = True
KEEP_POINTS_EVERY = 8


def record(args: dict, i: int) -> dict:
    x = args["x"]
    return dict(n=x.shape[0], x=x if i % KEEP_POINTS_EVERY == 0 else None)
