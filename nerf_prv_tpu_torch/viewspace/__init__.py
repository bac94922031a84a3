"""Hemisphere view spaces and novel view sets (the port of ``viewspace/``)."""

from .hemisphere import (
    ViewSpace,
    generate_all,
    generate_hemisphere,
    load_path_order,
    load_view_space,
    min_pairwise_angle,
    save_path_order,
    save_view_space,
    sum_pairwise_distance,
)
from .novel import get_or_create_novel_views, sample_novel_views

__all__ = [
    "ViewSpace",
    "generate_all",
    "generate_hemisphere",
    "load_path_order",
    "load_view_space",
    "min_pairwise_angle",
    "save_path_order",
    "save_view_space",
    "sum_pairwise_distance",
    "get_or_create_novel_views",
    "sample_novel_views",
]
