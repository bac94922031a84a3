"""``toy_axpy``: the toy program's update, a*x + y.  Its bound needs only the
launch's element count."""

MODULE = "toyprog"
KERNEL = "toy_axpy_kernel"
MEMSET_BEFORE = False


def record(args: dict, i: int) -> dict:
    return dict(n=args["y"].numel())
