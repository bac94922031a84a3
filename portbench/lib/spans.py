"""The program's spans in a traced call, and the device's idle time under
them.

The program records a span (``nerf_prv_tpu_torch.utils.timing.span``)
only while a profiler runs, stamped in ``time.time_ns()`` nanoseconds, the
clock of the trace's host and device events; its buffer outlives the
profiler, so the spans of one traced call are found by time.  A program
without the recorder gives no spans, and every reader of them then
reports nothing.
"""

from __future__ import annotations

import importlib
from typing import List, Optional, Sequence, Tuple

from .trace import Trace

Interval = Tuple[int, int]


def program_spans(trace: Optional[Trace]) -> Optional[list]:
    """The spans the program recorded during the traced call: those that
    meet the call's interval, from the earliest to the latest of its host
    and device events (an entry call's span opens just before its first
    op).  ``profile`` may take the call up to three times; the spans of an
    earlier try end before the last try's first event.  None without a
    trace, or where the program has no recorder."""
    if trace is None:
        return None
    try:
        timing = importlib.import_module("nerf_prv_tpu_torch.utils.timing")
    except ImportError:
        return None
    read = getattr(timing, "spans", None)
    ops = list(trace.device_ops) + [op for ops in trace.host_ops.values() for op in ops]
    if read is None or not ops:
        return None
    lo, hi = min(op.start for op in ops), max(op.end for op in ops)
    return [s for s in read() if s.end_ns >= lo and s.start_ns <= hi]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``(start, end)`` intervals, as disjoint intervals in order."""
    out: List[Interval] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def covered_ns(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """Length of the overlap of two unions of disjoint, ordered intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ns(trace: Trace, intervals: Sequence[Interval]) -> int:
    """The part of the union of ``intervals`` that no device op covers: the
    idle time ``busy_ns`` leaves out, over the same device ops."""
    spans = union(intervals)
    busy = union([(op.start, op.end) for op in trace.device_ops])
    return sum(hi - lo for lo, hi in spans) - covered_ns(spans, busy)


def idle_under(trace: Trace, spans: Optional[list], name: str) -> Optional[int]:
    """Device idle nanoseconds under the spans called ``name`` (the union of
    their intervals less the part the union of ``trace.device_ops``
    covers); None where there is no such span."""
    mine = [(s.start_ns, s.end_ns) for s in spans or () if s.name == name]
    if not mine:
        return None
    return idle_ns(trace, mine)
