"""The port's own kernel launches per training step over the window, as the
kernel wrappers count them (row gathers and scatter-adds, hash encodes and
table gradients)."""


def read(run):
    total = sum(run.launches.values())
    return total / (run.calls * run.runner.steps_per_call()) if total else None
