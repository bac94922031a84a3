"""Dataset-prep pipeline stages of the port (so far: coverage and novel-view
datasets, size test, ShapeNet preprocessing and cleaning)."""

from .coverage import get_clean_data, get_coverage, shapenet_preprocess

__all__ = ["get_coverage", "get_clean_data", "shapenet_preprocess"]
