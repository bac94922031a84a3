"""Device milliseconds of the port's own kernels per frame in the traced
eval (each launch with the memset its wrapper issues before it)."""

from lib.trace import OWN_KERNELS, kernel_times


def read(run):
    if run.trace is None or not run.trace.complete:
        return None
    ns = sum(sum(kernel_times(run.trace, w)) for w in OWN_KERNELS)
    if not ns:
        return None
    return ns / 1e6 / run.runner.cell.traffic["test_views"]
