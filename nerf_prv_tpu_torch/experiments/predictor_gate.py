"""Refuse to write comparison rows with a degenerate predictor.

Counterpart of ``experiments/predictor_gate.py``: the held-out evaluation's
rows pin their budgets, so a near-constant predictor (val correlation ~0,
predictions spanning ~0 views) would fill the tables with noise.  The gate
reads the predictor's val diagnostics (``val_pred_gt_corr``,
``val_pred_min_max``) from a training artifact before any row is written:
the port's own result JSON (``prvnet_recipe.run_two_stage``'s) or a
committed one.  The floors are the reference's.
"""

from __future__ import annotations

import json
import os

MIN_CORR = 0.3  # val pred-gt correlation floor (a constant predictor is ~0)
MIN_SPAN = 5.0  # views between the smallest and the largest val prediction


def predictor_gate(artifact: str, skip: bool = False) -> dict:
    """Exit unless the predictor's val metrics in ``artifact`` (a JSON path)
    clear ``MIN_CORR`` and ``MIN_SPAN``; returns the artifact's dict
    (``{}`` when ``skip``, ``predict_budgets --skip-gate``, for debugging)."""
    if skip:
        return {}
    if not os.path.exists(artifact):
        raise SystemExit(f"predictor gate: {artifact} missing: train the predictor first; rows would be noise")
    with open(artifact) as f:
        a = json.load(f)
    corr = float(a.get("val_pred_gt_corr", 0.0))
    lo, hi = a.get("val_pred_min_max", [0.0, 0.0])
    span = float(hi) - float(lo)
    if corr < MIN_CORR or span < MIN_SPAN:
        raise SystemExit(
            f"predictor gate: val corr {corr:.3f} (need >= {MIN_CORR}) / pred span {span:.1f} views "
            f"(need >= {MIN_SPAN}): refusing to write comparison rows with a degenerate predictor")
    print(f"[gate] predictor ok: corr {corr:.3f}, span {span:.1f}", flush=True)
    return a
