"""The whole training step's share of the card's published dense bf16 peak:
the MLP operations the window's calls need (forward and backward at every
march sample, the density forward at every probe sample,
``arith.train_flops``) over the window's time."""


def read(run):
    if run.peaks is None:
        return None
    flops = run.runner.flops_per_call() * run.calls
    return 100.0 * flops / run.wall_s / run.peaks["bf16_flops_per_s"]
