"""Timing, profiling and offline debug visualization."""

from .timing import GLOBAL_TIMINGS, Stopwatch, TimingRegistry, device_trace
from .visualize import (
    export_trajectory_ply,
    export_view_space_ply,
    plot_view_space_png,
    trajectory_polyline,
)

__all__ = [
    "GLOBAL_TIMINGS",
    "Stopwatch",
    "TimingRegistry",
    "device_trace",
    "export_trajectory_ply",
    "export_view_space_ply",
    "plot_view_space_png",
    "trajectory_polyline",
]
