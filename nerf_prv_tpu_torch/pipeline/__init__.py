"""The pipeline of the port: coverage and novel-view datasets, the NBV
loop with its five view-selection methods, the budget comparison (mode 7),
the mode dispatcher and its command line."""

from . import modes
from .coverage import get_clean_data, get_coverage, shapenet_preprocess
from .nbv import (
    METHOD_NAMES,
    NBVRunner,
    ensemble_uncertainty_rgb,
    ensemble_uncertainty_rgb_density,
    score_candidates_rgb,
    score_candidates_rgb_density,
)

__all__ = [
    "modes",
    "get_coverage",
    "get_clean_data",
    "shapenet_preprocess",
    "METHOD_NAMES",
    "NBVRunner",
    "ensemble_uncertainty_rgb",
    "ensemble_uncertainty_rgb_density",
    "score_candidates_rgb",
    "score_candidates_rgb_density",
]
