"""The mode-21 five-method view-planning table on the port's held-out roster.

Counterpart of ``experiments/exp_mode21_r4.py``: five test-roster objects
(one per family, :func:`pick_objects`) through methods 4 (PVBCoverage, PRV),
0 (RandomIterative), 1 (RandomOneshot), 2 (EnsembleRGB, 2 NeRFs an
iteration) and 3 (EnsembleRGBDensity, 5) of the port's
``mode_view_planning``, on a 64-view candidate space at the 320x180 camera
with 1,200-step fields and ``evaluate=True`` (the last iteration's field
scored on the 100-view set).  Methods 0-3 replay method 4's
``view_budget.txt``, so an object's method 4 runs first in the same
workspace.  A row is read off the experiment directory as the reference
reads it (:func:`read_row`); :func:`summarize` is its ``_summarize``.

The reference's method 4 reads the tiny@720 predictor through
``HDPredictor`` (``mode7_compare.live_predictor`` wraps a checkpoint so).
The check runs method 4 with :class:`PinnedPredictor`, which answers each
object's pinned budget through the same ``predict_from_coverage`` call, so
the reference's code path (the budget's view space, its TSP path, the
replay) runs with the committed budget; ``check_hd`` runs it live.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from ..core.config import Config
from ..nerf.model import NerfConfig
from ..pipeline.nbv import METHOD_NAMES
from .corpus_dataset import ARTIFACTS
from .label_protocol import pipeline_config, require_device

METHODS = (4, 0, 1, 2, 3)
# occlusion-heavy families first: they tell NBV methods apart (exp_mode21_r4.py:49-50)
FAMILY_ORDER = ("clu", "cup", "pla", "spi", "van", "tor", "box", "ell", "nos", "fan", "blo", "uni")


def pick_objects(n: int, art: str = ARTIFACTS) -> list:
    """One test-roster object per family in ``FAMILY_ORDER``, topped up from
    the roster (≙ exp_mode21_r4.py:40-59)."""
    with open(os.path.join(art, "dataset300_stats.json")) as f:
        test = json.load(f)["test"]
    by_fam = {}
    for name in test:
        by_fam.setdefault(name[:3], []).append(name)
    picked = []
    for fam in FAMILY_ORDER:
        if fam in by_fam and len(picked) < n:
            picked.append(sorted(by_fam[fam])[0])
    for name in test:
        if len(picked) >= n:
            break
        if name not in picked:
            picked.append(name)
    return picked[:n]


def mode21_config(root: str) -> Config:
    """The protocol's configuration with the 64-view candidate space, 60
    iterations at most and the final evaluation (≙ exp_mode21_r4.py:71-73)."""
    return pipeline_config(root).replace(num_of_views=64, num_of_max_iteration=60, evaluate=True)


def committed(art: str = ARTIFACTS) -> dict:
    """The JAX package's committed mode-21 artifact (``mode21_r4.json``)."""
    with open(os.path.join(art, "mode21_r4.json")) as f:
        return json.load(f)


class PinnedPredictor:
    """Answers ``predict_from_coverage`` with the pinned budget of the
    object whose coverage directory it is given (``<gt_path>/5``)."""

    def __init__(self, budgets: Dict[str, int]):
        self.budgets = {k: int(v) for k, v in budgets.items()}
        self.calls = []

    def predict_from_coverage(self, coverage_dir: str, view_ids) -> int:
        name = os.path.basename(os.path.dirname(os.path.normpath(coverage_dir)))
        self.calls.append((name, list(view_ids)))
        return self.budgets[name]


def read_row(path: str, method: int) -> dict:
    """One table row from an experiment directory (≙ exp_mode21_r4.py:99-133):
    the budget (method 4's ``view_budget.txt``), the last iteration's PSNR
    and SSIM with the views it trained on, and the total movement (the
    last movement file's third column, 4 decimals)."""
    from ..nerf.api import load_metrics

    row = {"method": METHOD_NAMES[method]}
    bud = os.path.join(path, "view_budget.txt")
    if os.path.exists(bud):
        with open(bud) as f:
            row["budget"] = int(float(f.read().split()[0]))
    mdir = os.path.join(path, "metrics")
    finals = sorted((f for f in os.listdir(mdir) if f.endswith(".txt")), key=lambda f: int(f[:-4]))
    if finals:
        m = load_metrics(os.path.join(mdir, finals[-1]))
        row["PSNR"] = round(m["PSNR"], 3)
        row["SSIM"] = round(m["SSIM"], 4)
        row["n_views_trained"] = int(finals[-1][:-4]) + 1
    movement = total_movement(path)
    if movement is not None:
        row["movement"] = round(movement, 4)
    return row


def total_movement(path: str) -> Optional[float]:
    """The experiment's total movement cost: the last movement file's third
    column, unrounded (None before the first move)."""
    mvdir = os.path.join(path, "movement")
    mv = sorted((f for f in os.listdir(mvdir) if f[:-4].lstrip("-").isdigit()), key=lambda f: int(f[:-4]))
    if not mv:
        return None
    with open(os.path.join(mvdir, mv[-1])) as f:
        return float(f.read().split()[-1])


def run_rows(cfg: Config, names: Sequence[str], methods: Sequence[int], predictor, device="cuda",
             nerf_cfg: Optional[NerfConfig] = None, coverage_sizes=None) -> dict:
    """Mode 21 for each (name, method) in order: {"<name>/m<method>": row}
    with the row's wall.  The predictor goes to method 4 only.
    ``coverage_sizes`` is ``mode_view_planning``'s (its default: the
    64-view space, 5..60, 100)."""
    from ..pipeline import modes

    device = require_device(device)
    nerf_cfg = nerf_cfg or NerfConfig(n_steps=cfg.n_steps)
    rows = {}
    for name in names:
        for method in methods:
            t0 = time.perf_counter()
            paths = modes.mode_view_planning(cfg, [name], method_ids=(method,), init_view_cases=((0, 1, 3),),
                                             nerf_cfg=nerf_cfg, predictor=predictor if method == 4 else None,
                                             coverage_sizes=coverage_sizes, device=device)
            row = read_row(paths[0], method) if paths else {"method": METHOD_NAMES[method]}
            row["seconds"] = round(time.perf_counter() - t0, 1)
            rows[f"{name}/m{method}"] = row
    return rows


def summarize(out: dict) -> dict:
    """Per-method n and the mean / std of PSNR, SSIM and movement over the
    rows with a PSNR, into ``out["summary"]`` (≙ exp_mode21_r4.py:144-163)."""
    summary = {}
    for method in METHODS:
        recs = [r for k, r in out["rows"].items() if k.endswith(f"/m{method}") and "PSNR" in r]
        if not recs:
            continue
        entry = {"n": len(recs)}
        for field in ("PSNR", "SSIM", "movement"):
            v = np.array([r[field] for r in recs if field in r], np.float64)
            if len(v):
                entry[field] = {"mean": round(float(v.mean()), 4),
                                "std": round(float(v.std(ddof=1)) if len(v) > 1 else 0.0, 4)}
        summary[METHOD_NAMES[method]] = entry
    out["summary"] = summary
    return out
