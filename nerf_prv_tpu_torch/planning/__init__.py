"""Local paths and the TSP view-order planner (the port of ``planning/``)."""

from .local_path import (
    CIRCLE_PATH,
    LINE_PATH,
    WRONG_PATH,
    local_path,
    pairwise_lengths,
    trajectory,
)
from .tsp import GlobalPathPlanner, precompute_paths, solve_open_tsp

__all__ = [
    "CIRCLE_PATH",
    "LINE_PATH",
    "WRONG_PATH",
    "local_path",
    "pairwise_lengths",
    "trajectory",
    "GlobalPathPlanner",
    "precompute_paths",
    "solve_open_tsp",
]
