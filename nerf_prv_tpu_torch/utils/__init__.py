"""Spans, the device trace and offline debug visualization."""

from .timing import device_trace, drain, span, spans
from .visualize import (
    export_trajectory_ply,
    export_view_space_ply,
    plot_view_space_png,
    trajectory_polyline,
)

__all__ = [
    "device_trace",
    "drain",
    "export_trajectory_ply",
    "export_view_space_ply",
    "plot_view_space_png",
    "span",
    "spans",
    "trajectory_polyline",
]
