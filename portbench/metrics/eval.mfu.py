"""The whole eval's share of the card's published dense bf16 peak: the MLP
operations the window's evals need (the march's forward at every sample of
the rays the reference's probes keep on the same field and cameras, and the
probes' density forward, ``arith.eval_flops``) over the window's time."""


def read(run):
    flops = run.runner.flops_per_call()
    if run.peaks is None or flops is None:
        return None
    return 100.0 * flops * run.calls / run.wall_s / run.peaks["bf16_flops_per_s"]
