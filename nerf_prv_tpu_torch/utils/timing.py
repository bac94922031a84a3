"""Spans on the profiler's clock, and the operator's device trace.

``span(name)`` marks a stretch of the program (a training step, an eval's
render of a group of frames) while a ``torch.profiler`` runs, and costs
one C call and a branch when none does.  A recorded span keeps its name,
its start and end in ``time.time_ns()`` nanoseconds (the clock kineto
stamps host events with, so a span lines up with the trace's host and
device events without conversion), the span it opened inside and the
outermost span of its thread: the root, the entry call every span of one
request shares.  Spans go to one bounded buffer in memory, read by
:func:`spans` and emptied by :func:`drain`; this module writes no file of
its own.  A span is attributed by time, not by thread: autograd's device
thread runs a backward inside the caller's span.

:func:`device_trace` writes a Perfetto / ``chrome://tracing`` file of the
host, the device and the spans recorded meanwhile, on one time base.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Iterator, List, NamedTuple, Optional

import torch

SPAN_BUFFER = 1 << 17  # spans kept; the oldest go first
SPANS_TRACK = "program spans"
_SPANS_TID = 2**31 - 1  # a thread id no host thread has: the spans' own track

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_buffer: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_open = threading.local()
_ids = itertools.count(1)


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]  # the span it opened inside, or None
    root: int              # the outermost open span of its thread (its own id for a root)


class _Recording:
    __slots__ = ("name", "id", "parent", "root", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent, self.root = (stack[-1].id, stack[-1].root) if stack else (None, self.id)
        stack.append(self)
        self.start_ns = time.time_ns()

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        _stack().pop()
        _buffer.append(Span(self.name, self.start_ns, end, self.id, self.parent, self.root))
        return False  # an exception leaving the span closes it and goes on


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def span(name: str):
    """A context manager that records a span called ``name`` while a torch
    profiler is active on this thread; otherwise one shared context that
    does nothing."""
    return _Recording(name) if _profiling() else _OFF


def spans() -> List[Span]:
    """The recorded spans, in the order they closed."""
    return list(_buffer)


def drain() -> List[Span]:
    """The recorded spans, emptying the buffer."""
    out = []
    while _buffer:
        out.append(_buffer.popleft())
    return out


def _chrome_events(recorded: List[Span], base_ns: int) -> list:
    """The spans as complete events of one track, timestamps in microseconds
    from ``base_ns`` (a kineto trace's ``baseTimeNanoseconds``)."""
    pid, tid = os.getpid(), _SPANS_TID
    events = [dict(ph="M", name="thread_name", pid=pid, tid=tid, args=dict(name=SPANS_TRACK))]
    for s in recorded:
        events.append(dict(ph="X", cat="program_span", name=s.name, pid=pid, tid=tid,
                           ts=(s.start_ns - base_ns) / 1e3, dur=(s.end_ns - s.start_ns) / 1e3,
                           args=dict(id=s.id, parent=s.parent, root=s.root)))
    return events


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the host and the CUDA device
    (when one is visible), with the spans recorded meanwhile as one
    "program spans" track, into ``<log_dir>/trace.json`` (open it in
    Perfetto or ``chrome://tracing``)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        lo = time.time_ns()
        yield
        hi = time.time_ns()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    mine = [s for s in spans() if lo <= s.start_ns and s.end_ns <= hi]
    trace["traceEvents"].extend(_chrome_events(mine, int(trace.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(trace, f)
