"""Milliseconds a frame the device is idle under the program's
``eval.render`` spans in the traced eval (each group's ray assembly,
compaction, probes and march): their union less the part the call's
device ops cover, over the eval's frames."""

from lib.spans import idle_under, program_spans


def read(run):
    ns = idle_under(run.trace, program_spans(run.trace), "eval.render")
    return None if ns is None else ns / 1e6 / run.runner.cell.traffic["test_views"]
