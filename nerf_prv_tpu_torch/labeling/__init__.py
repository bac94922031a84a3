"""PSNR-curve labeling and PRVNet dataset assembly (the port of ``labeling/``)."""

from .dataset import (
    CATEGORY_PREFIXES,
    build_dataset,
    read_sorted_object_names,
    select_labels,
    stratified_split,
)
from .labels import (
    LabelResult,
    X_EVAL,
    fit_object_from_metrics,
    fit_objects,
    labels_from_curve,
    parse_label_file,
    write_label_file,
)
from .lognormal import FitResult, eval_curve, fit_batch, fit_lognormal, lognormal_cdf
from .stats import aggregate_labels, read_all_labels, write_label_stats

__all__ = [
    "CATEGORY_PREFIXES",
    "build_dataset",
    "read_sorted_object_names",
    "select_labels",
    "stratified_split",
    "LabelResult",
    "X_EVAL",
    "fit_object_from_metrics",
    "fit_objects",
    "labels_from_curve",
    "parse_label_file",
    "write_label_file",
    "FitResult",
    "eval_curve",
    "fit_batch",
    "fit_lognormal",
    "lognormal_cdf",
    "aggregate_labels",
    "read_all_labels",
    "write_label_stats",
]
