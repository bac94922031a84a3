"""Milliseconds a step the device is idle under the program's ``train.step``
spans in the traced training call (sampling, forward, backward, Adam):
their union less the part the call's device ops cover, over the call's
steps."""

from lib.spans import idle_under, program_spans


def read(run):
    ns = idle_under(run.trace, program_spans(run.trace), "train.step")
    return None if ns is None else ns / 1e6 / run.runner.steps_per_call()
