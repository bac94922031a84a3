"""Structured timing and profiling.

Counterpart of ``nerf_prv_tpu/utils/timing.py``: the reference's wall-clock
observability (``Share_Data::out_clock`` delta timer; per-phase prints; the
persisted ``train_time/<iter>.txt`` / ``infer_time/<iter>.txt`` /
``run_time.txt`` artifacts) as one structured registry, plus a
``torch.profiler`` trace hook for device-level analysis.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional


class Stopwatch:
    """Delta timer (≙ Share_Data::out_clock)."""

    def __init__(self):
        self._last = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        delta = now - self._last
        self._last = now
        return delta


class TimingRegistry:
    """Named phase timings with file persistence matching the reference's
    artifact layout (one value per file under ``<dir>/<phase>/<name>.txt``)."""

    def __init__(self):
        self.records: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records[name].append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self.records.get(name, []))

    def write_artifact(self, root: str, phase: str, name: str, value: Optional[float] = None) -> None:
        """≙ the train_time/infer_time/run_time txt files (main.cpp:1707-1711,
        2250-2253, 1948-1951)."""
        d = os.path.join(root, phase)
        os.makedirs(d, exist_ok=True)
        v = value if value is not None else self.total(phase)
        with open(os.path.join(d, f"{name}.txt"), "w") as f:
            f.write(f"{v}\n")

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.records.items():
            out[name] = {
                "count": len(vals),
                "total_s": sum(vals),
                "mean_s": sum(vals) / len(vals),
                "max_s": max(vals),
            }
        return out

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


GLOBAL_TIMINGS = TimingRegistry()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the host and the CUDA device
    (when one is visible) into ``<log_dir>/trace.json`` (open it in
    Perfetto or ``chrome://tracing``)."""
    import torch

    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
