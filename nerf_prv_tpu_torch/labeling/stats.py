"""Label statistics — mode 5 (ReadLabel) equivalent.

Counterpart of ``nerf_prv_tpu/labeling/stats.py`` (numpy, copied).

≙ ``main.cpp:2490-2638``: parse every object's ``label.txt``, then per label
type (11 gap values, 20 gradient thresholds) compute mean / sample std /
fail-count / min / max and the integer histogram, written as
``label_mean_std.txt`` and ``label_distribution.txt`` in the reference's
tab-separated format.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from .labels import LabelResult, N_GAPS, N_GRADIENTS, parse_label_file


def aggregate_labels(results: Sequence[LabelResult]) -> Dict[str, dict]:
    out = {}
    for kind, count in (("gap", N_GAPS), ("gradient", N_GRADIENTS)):
        rows = []
        for v in range(count):
            vals = np.array(
                [
                    (r.gap_labels if kind == "gap" else r.gradient_labels)[v]
                    for r in results
                    if r.converged
                    and (r.gap_labels if kind == "gap" else r.gradient_labels)[v] != -1
                ],
                dtype=np.float64,
            )
            n = len(vals)
            label_value = f"{v}%" if kind == "gap" else f"{0.01 * (v + 1):.2f}"
            if n == 0:
                rows.append(
                    dict(value=label_value, mean=np.nan, std=np.nan,
                         fail_num=len(results), min=np.nan, max=np.nan,
                         distribution={})
                )
                continue
            mean = vals.mean()
            std = vals.std(ddof=1) if n > 1 else 0.0
            dist = {}
            for x in vals.astype(int):
                dist[x] = dist.get(x, 0) + 1
            rows.append(
                dict(
                    value=label_value,
                    mean=mean,
                    std=std,
                    fail_num=len(results) - (n - 1),  # ≙ main.cpp:2589 accounting
                    min=int(vals.min()),
                    max=int(vals.max()),
                    distribution=dict(sorted(dist.items())),
                )
            )
        out[kind] = rows
    return out


def write_label_stats(workspace: str, results: Sequence[LabelResult]) -> Dict[str, dict]:
    """Write ``label_mean_std.txt`` + ``label_distribution.txt``
    (≙ main.cpp:2554-2637)."""
    os.makedirs(workspace, exist_ok=True)
    agg = aggregate_labels(results)
    with open(os.path.join(workspace, "label_mean_std.txt"), "w") as f_ms, open(
        os.path.join(workspace, "label_distribution.txt"), "w"
    ) as f_d:
        f_ms.write("type\tvalue\tmean\tstd\tfail_num\tmin\tmax\n")
        for kind in ("gap", "gradient"):
            for row in agg[kind]:
                f_ms.write(
                    f"{kind}\t{row['value']}\t{row['mean']}\t{row['std']}\t"
                    f"{row['fail_num']}\t{row['min']}\t{row['max']}\n"
                )
                f_d.write(f"{kind}\t{row['value']}\n")
                for k, v in row["distribution"].items():
                    f_d.write(f"{k}\t{v}\n")
                f_d.write("\n")
    return agg


def read_all_labels(
    label_root: str, names: Sequence[str], batch_size: int = 3000
) -> List[LabelResult]:
    """Parse per-object label files laid out like the reference's batches
    (``Coverage_images/ShapeNet_<batch>_label/<name>/label.txt``,
    main.cpp:2496-2498)."""
    results = []
    for i, name in enumerate(names):
        batch = i // batch_size
        path = os.path.join(label_root, f"ShapeNet_{batch}_label", name, "label.txt")
        if not os.path.exists(path):
            path = os.path.join(label_root, name, "label.txt")
        results.append(parse_label_file(path))
    return results
