"""Share of the window the device is idle in an eval: one whole
call's device busy time in the trace (the union of its kernels, copies and
sets), over the un-profiled wall time of one call of the window."""

from lib.trace import busy_ns


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    return 100.0 * (1.0 - busy_ns(run.trace.device_ops) / 1e9 / (run.wall_s / run.calls))
