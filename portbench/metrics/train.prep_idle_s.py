"""Seconds the device is idle under the trainer's set-up span ``train.prep``
in the traced training call (stacking the datasets, their upload and hit
pools, the parameters and their Adam): the union of the program's
``train.prep`` spans less the part the call's device ops cover."""

from lib.spans import idle_under, program_spans


def read(run):
    ns = idle_under(run.trace, program_spans(run.trace), "train.prep")
    return None if ns is None else ns / 1e9
