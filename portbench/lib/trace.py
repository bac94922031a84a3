"""One unit of work (a call of the timed entry) under ``torch.profiler``:
device time by kernel, the device's busy time, the idle gaps by what the host
was doing, and the port's own kernel launches with their inputs.

The port's own kernels are the registry files ``kernels/<wrapper>.py``
(``spec.kernels``): each names the wrapper's module, the kernel's name in the
trace and what a launch's bound needs.  The launches are read where they
happen: ``sys.monitoring`` calls back at the start of each wrapper (found by
its code object, wherever it is called from) and keeps the registry's record
of the launch (its indices, or its sizes), so that a launch's bytes can be
counted from its own indices once the call is over.
The i-th recorded launch of a wrapper is the i-th kernel of that name on
the device (one stream, in order).  The trace counts as complete when the
own kernels it saw equal the wrappers' launch counters (``chip_smoke.py``'s
``profile_device`` rule); it is taken again, up to three times, until they
do.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple

import torch

from .spec import kernels

# wrapper name -> its registry file; the wrappers count their own launches
# in ``<wrapper>.launches``
OWN_KERNELS = kernels()
FAMILIES = (  # first match wins (chip_smoke.py's _FAMILIES)
    ("GEMMs", ("gemm", "nvjet", "cutlass", "cublas", "splitK")),
    ("Adam", ("multi_tensor_apply",)),
    ("copies and cats", ("CatArray", "copy_kernel", "Memcpy", "Memset")),
    ("library indexing", ("index", "gather", "scatter")),
    ("reductions and scans", ("reduce_kernel", "scan")),
    ("elementwise", ("elementwise",)),
)
_TOOL = 4


def wrappers() -> Dict[str, Callable]:
    """Each registry file's wrapper; a port module or wrapper that is absent
    is an error: a kernel the registry names is never skipped."""
    import importlib

    out = {}
    for name, k in OWN_KERNELS.items():
        try:
            fn = getattr(importlib.import_module(k.MODULE), name)
        except (ImportError, AttributeError) as e:
            raise RuntimeError(f"kernels/{name}.py names the wrapper {k.MODULE}.{name}, which is absent") from e
        out[name] = fn
    return out


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def own_kernel(name: str) -> str:
    """The wrapper whose kernel this trace name is (the longest kernel name
    in it), or ''."""
    found = [(len(k.KERNEL), wrapper) for wrapper, k in OWN_KERNELS.items() if k.KERNEL in name]
    return max(found)[1] if found else ""


def family(name: str) -> str:
    own = own_kernel(name)
    if own:
        return own
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


class Recorder:
    """Keeps a record of every kernel wrapper's launch while it is on."""

    def __init__(self):
        self.calls: Dict[str, List[dict]] = defaultdict(list)
        self.codes = {fn.__code__: name for name, fn in wrappers().items()}

    def _start(self, code, offset):
        name = self.codes[code]
        self.calls[name].append(OWN_KERNELS[name].record(sys._getframe(1).f_locals, len(self.calls[name])))

    def __enter__(self):
        mon = sys.monitoring
        mon.use_tool_id(_TOOL, "portbench")
        mon.register_callback(_TOOL, mon.events.PY_START, self._start)
        for code in self.codes:
            mon.set_local_events(_TOOL, code, mon.events.PY_START)
        return self

    def __exit__(self, *exc):
        mon = sys.monitoring
        for code in self.codes:
            mon.set_local_events(_TOOL, code, 0)
        mon.register_callback(_TOOL, mon.events.PY_START, None)
        mon.free_tool_id(_TOOL)


class Op(NamedTuple):
    name: str
    start: int   # ns
    end: int     # ns


class Trace(NamedTuple):
    device_ops: List[Op]         # device kernels, copies and sets, by start
    host_ops: Dict[int, List[Op]]  # per host thread, by start
    launches: Dict[str, List[dict]]  # wrapper -> record of each launch, in order
    counted: Dict[str, int]      # launches the wrappers counted
    complete: bool
    wall_s: float                # the profiled call's wall time
    attempts: int


def profile(fn: Callable, tries: int = 3) -> Trace:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        with Recorder() as rec, torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = {name: n - before[name] for name, n in launch_counts().items()}
        device, host = [], defaultdict(list)
        for e in prof.profiler.kineto_results.events():
            op = Op(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # "Optimizer.step#..." is a span drawn on the device's track
                if not op.name.startswith("Optimizer."):
                    device.append(op)
            else:
                host[e.start_thread_id()].append(op)
        device.sort(key=lambda o: o.start)
        for ops in host.values():
            ops.sort(key=lambda o: o.start)
        seen = defaultdict(int)
        for op in device:
            own = own_kernel(op.name)
            if own:
                seen[own] += 1
        complete = all(seen[name] == n for name, n in counted.items())
        # a wrapper called with no rows launches nothing and counts nothing
        launches = {name: [a for a in rec.calls.get(name, []) if a["n"] > 0] for name in counted}
        if complete:
            break
    return Trace(device, dict(host), launches, counted, complete, wall, attempt)


def busy_ns(ops: List[Op]) -> int:
    """Length of the union of the device ops' intervals."""
    total, cur_s, cur_e = 0, None, None
    for op in ops:
        if cur_e is None or op.start > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = op.start, op.end
        else:
            cur_e = max(cur_e, op.end)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def kernel_times(trace: Trace, wrapper: str) -> List[int]:
    """Device ns of each launch of ``wrapper``, in order, counting the
    memset just before its kernel where its registry file says the wrapper
    zeroes its output that way (a scatter-add, a table gradient)."""
    out = []
    ops = trace.device_ops
    memset = OWN_KERNELS[wrapper].MEMSET_BEFORE
    for i, op in enumerate(ops):
        if own_kernel(op.name) == wrapper:
            ns = op.end - op.start
            if memset and i and "Memset" in ops[i - 1].name:
                ns += ops[i - 1].end - ops[i - 1].start
            out.append(ns)
    return out


def device_breakdown(trace: Trace, top: int = 10) -> list:
    by = defaultdict(int)
    for op in trace.device_ops:
        by[family(op.name)] += op.end - op.start
    return [[name, ns / 1e9] for name, ns in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace: Trace, top: int = 10, least_ns: int = 2000) -> list:
    """The device's idle time between ops, summed by the innermost host op
    running at each gap's middle (over all host threads, the latest to
    start); gaps under ``least_ns`` are left out."""
    gaps, end = [], None
    for op in trace.device_ops:
        if end is not None and op.start - end >= least_ns:
            gaps.append((end, op.start))
        end = op.end if end is None else max(end, op.end)
    mids = [(lo + hi) // 2 for lo, hi in gaps]
    # one sweep a thread: a thread's ops nest, so the innermost op open at a
    # time is the top of the stack of ops started and not yet ended
    best = [None] * len(mids)
    for ops in trace.host_ops.values():
        stack, j = [], 0
        for q, mid in enumerate(mids):
            while j < len(ops) and ops[j].start <= mid:
                while stack and stack[-1].end < ops[j].start:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and stack[-1].end < mid:
                stack.pop()
            if stack and (best[q] is None or stack[-1].start > best[q].start):
                best[q] = stack[-1]
    by = defaultdict(int)
    for (lo, hi), op in zip(gaps, best):
        by[op.name if op else "host outside any op"] += hi - lo
    return [[name, ns / 1e9] for name, ns in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
