"""The mode-7 statistics comparison on the port's held-out roster.

Counterpart of ``experiments/exp_mode7_r4.py``: the 10 objects of the
committed test roster (``dataset300_stats.json`` ``test``), each trained and
scored at five budgets through the port's ``compare_objects``: its label
(``gt``), the statistics baselines mode / median / mean of the val split's
labels (``stat_budgets_from_labels``), and PRV's.  ``summarize`` gives the
dict the reference's ``_flush`` writes: the per-method means and standard
deviations and PRV's PSNR and path-length deltas against each baseline, with
their standard errors.

The reference's PRV arm reads the tiny@720 predictor through
:class:`HDPredictor`, which redirects it to the object's hd (1280x720)
5-view set (``corpus_dataset.render_hd_sets``); :func:`live_predictor` wraps
a checkpoint so wherever its crop is 720 or more, as the reference's scripts
do.  The port's runs take PRV's budgets pinned (the committed rows' ``prv``
budgets, or those a port predictor gave, see ``predict_budgets``) or from a
live predictor.

View spaces.  The reference's workspace held mode 0's sizes (3..47 step 4,
5, 64 and 100, ``generate_hemisphere(n, seed=n)``) and every other size as
``_ensure_viewspace`` wrote it (seed 0); :func:`install_eval_viewspace`
installs the shipped copies of both before a run.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.config import Config
from ..nerf.model import NerfConfig
from ..pipeline.compare import compare_objects, path_length_for_budget
from .corpus_dataset import ARTIFACTS
from .label_protocol import fit_counts, install_reference_viewspace, require_device, seed_workspace

BASELINES = ("mode", "median", "mean", "gt")
EVAL_SIZES = tuple(range(5, 61))  # mode 21's coverage sizes; mode 7's budgets lie among them


class HDPredictor:
    """Sends ``predict_from_coverage`` to the object's hd (1280x720) set of
    the same size when it exists, so that a predictor trained at crop 720
    sees the image geometry it was trained on; otherwise to the qcam
    directory it was given (≙ exp_mode7_r4.py:50-64)."""

    def __init__(self, inner):
        self.inner = inner

    def predict_from_coverage(self, coverage_dir: str, view_ids) -> int:
        hd_dir = os.path.join(os.path.dirname(coverage_dir), "hd", os.path.basename(coverage_dir))
        if os.path.isdir(hd_dir):
            coverage_dir = hd_dir
        return self.inner.predict_from_coverage(coverage_dir, view_ids)


def live_predictor(checkpoint: str, arch: str, crop: int, device="cuda"):
    """A ``BudgetPredictor`` on ``checkpoint``, behind :class:`HDPredictor`
    where ``crop`` is 720 or more: a 180-crop predictor trained on qcam
    images (≙ exp_mode7_r4.py:89-91, exp_mode21_r4.py:75-77)."""
    from ..prvnet.infer import BudgetPredictor

    predictor = BudgetPredictor(checkpoint, arch=arch, crop=crop, device=device)
    return HDPredictor(predictor) if crop >= 720 else predictor


def _read(art: str, name: str) -> dict:
    with open(os.path.join(art, name)) as f:
        return json.load(f)


def corpus_labels(art: str = ARTIFACTS) -> Tuple[Dict[str, int], Dict[str, int], list]:
    """(labels of every labelled object, the val split's labels, the test
    roster) as ``exp_mode7_r4.py:77-86`` reads them: the two committed label
    files and ``dataset300_stats.json``."""
    ds = _read(art, "dataset300_stats.json")
    legacy = _read(art, "dataset100_labels.json")["objects"]
    new = _read(art, "dataset300_labels.json")["objects"]
    labels = {n: o["label"] for n, o in {**legacy, **new}.items()}
    return labels, {n: labels[n] for n in ds["val"]}, list(ds["test"])


def committed(art: str = ARTIFACTS) -> dict:
    """The JAX package's committed mode-7 artifact (``mode7_r4.json``)."""
    return _read(art, "mode7_r4.json")


def committed_predictions(art: str = ARTIFACTS) -> Dict[str, int]:
    """name -> the committed rows' PRV budget."""
    return {n: e["prv"]["budget"] for n, e in committed(art)["rows"].items()}


def install_eval_viewspace(cfg: Config) -> None:
    """The reference's view-space files for every size the evaluation
    reads: mode 0's and the on-demand ones of 5..60."""
    install_reference_viewspace(cfg, sorted(set(fit_counts(cfg)) | {64, 100} | set(EVAL_SIZES)), probe=False)


def _evaluate_seeded(obj_cfg: Config, scene, budget: int, nerf_cfg: NerfConfig, seed: int, device) -> dict:
    """``evaluate_budget``'s steps at NeRF seed ``seed`` (the metrics cached
    in ``compare_<budget>.txt`` of ``obj_cfg``'s workspace): the budget's and
    the 100-view coverage sets, then ``run(..., seed=seed)``."""
    from ..nerf.api import load_metrics, run
    from ..pipeline.coverage import get_coverage

    metrics_file = os.path.join(obj_cfg.gt_path, f"compare_{budget}.txt")
    if os.path.exists(metrics_file):
        return load_metrics(metrics_file)
    return run(get_coverage(scene, obj_cfg, budget, device=device),
               test_transforms=get_coverage(scene, obj_cfg, 100, device=device),
               save_metrics_path=metrics_file, cfg=nerf_cfg, seed=seed, device=device)


def score_budget(cfg: Config, name: str, budget: int, seed: int = 0, device="cuda",
                 nerf_cfg: Optional[NerfConfig] = None) -> dict:
    """One object's field at one budget and NeRF seed, scored as mode 7
    scores it: {PSNR, SSIM, path_len, wall_s}.  Seed 0 trains through
    ``evaluate_budget`` in ``cfg``'s workspace (where mode 7 then finds it),
    another seed in :func:`seed_workspace`'s."""
    from ..pipeline.compare import evaluate_budget
    from ..scene.object_setup import load_object

    device = require_device(device)
    nerf_cfg = nerf_cfg or NerfConfig(n_steps=cfg.n_steps)
    obj_cfg = seed_workspace(cfg, seed).replace(name_of_pcd=name)
    scene = load_object(obj_cfg, name, device=device)
    if not scene.ok:
        raise RuntimeError(f"{name}: the object did not load")
    t0 = time.perf_counter()
    if seed == 0:
        m = evaluate_budget(obj_cfg, scene, budget, nerf_cfg, device=device)
    else:
        m = _evaluate_seeded(obj_cfg, scene, budget, nerf_cfg, seed, device)
    return {"PSNR": m["PSNR"], "SSIM": m["SSIM"], "wall_s": time.perf_counter() - t0,
            "path_len": path_length_for_budget(obj_cfg, scene.view_space, budget, device=device)}


def _seeded_rows(cfg: Config, names: Sequence[str], labels: Dict[str, int], stat_budgets: Dict[str, int],
                 predictor, predictions, seed: int, nerf_cfg: NerfConfig, device) -> Dict[str, dict]:
    """``compare_objects``' rows at NeRF seed ``seed``, in the seed's own
    workspace (``compare_objects`` caches by ``compare_<budget>.txt`` and
    trains at seed 0)."""
    from ..pipeline.coverage import get_coverage
    from ..scene.object_setup import load_object

    cfg = seed_workspace(cfg, seed)
    rows = {}
    for name in names:
        obj_cfg = cfg.replace(name_of_pcd=name)
        scene = load_object(obj_cfg, name, device=device)
        if not scene.ok:
            continue
        budgets = {"gt": labels[name], **stat_budgets}
        if predictions is not None and name in predictions:
            budgets["prv"] = int(predictions[name])
        elif predictor is not None:
            get_coverage(scene, obj_cfg, 5, device=device)
            budgets["prv"] = predictor.predict_from_coverage(os.path.join(obj_cfg.gt_path, "5"), [0, 1, 3])
        entry = {}
        for key, b in budgets.items():
            m = _evaluate_seeded(obj_cfg, scene, int(b), nerf_cfg, seed, device)
            entry[key] = {"budget": int(b), "PSNR": m["PSNR"], "SSIM": m["SSIM"],
                          "path_len": path_length_for_budget(obj_cfg, scene.view_space, int(b), device=device)}
        rows[name] = entry
    return rows


@contextlib.contextmanager
def _timed_fields(walls: dict):
    """Time each field where ``compare_objects`` trains it: its
    ``evaluate_budget`` calls, wrapped, write ``walls[(name, budget)]``
    (the first call of a budget, which trains; a repeat reads the cache)."""
    from ..pipeline import compare as compare_mod

    real = compare_mod.evaluate_budget

    def timed(obj_cfg, scene, budget, *args, **kwargs):
        t0 = time.perf_counter()
        out = real(obj_cfg, scene, budget, *args, **kwargs)
        walls.setdefault((obj_cfg.name_of_pcd, int(budget)), time.perf_counter() - t0)
        return out

    compare_mod.evaluate_budget = timed
    try:
        yield
    finally:
        compare_mod.evaluate_budget = real


def run_mode7(cfg: Config, names: Sequence[str], labels: Dict[str, int], stat_budgets: Dict[str, int],
              predictor=None, predictions: Optional[Dict[str, int]] = None, seed: int = 0, device="cuda",
              nerf_cfg: Optional[NerfConfig] = None, walls: Optional[dict] = None,
              out_file: Optional[str] = None) -> Dict[str, dict]:
    """Mode 7 for ``names``: {name: {gt|mode|median|mean|prv: {budget,
    PSNR, SSIM, path_len}}}.  At NeRF seed 0 this is the port's
    ``compare_objects``, each distinct budget's field timed into
    ``walls[(name, budget)]`` when given; another seed trains in its own
    workspace.  ``nerf_cfg`` defaults to ``NerfConfig(n_steps=cfg.n_steps)``;
    ``out_file`` is ``compare_objects``' table (its default, the
    workspace's ``pvb_statistic_compare.txt``)."""
    device = require_device(device)
    nerf_cfg = nerf_cfg or NerfConfig(n_steps=cfg.n_steps)
    if seed != 0:
        return _seeded_rows(cfg, names, labels, stat_budgets, predictor, predictions, seed, nerf_cfg, device)
    with _timed_fields(walls) if walls is not None else contextlib.nullcontext():
        return compare_objects(cfg, names, labels, predictor=predictor, nerf_cfg=nerf_cfg, out_file=out_file,
                               stat_budgets=stat_budgets, predictions=predictions, device=device)


def _sem(v) -> float:
    return round(float(np.std(v, ddof=1) / np.sqrt(len(v))) if len(v) > 1 else 0.0, 4)


def summarize(rows: Dict[str, dict], stat_budgets: Dict[str, int], val_n: int, n_roster: int) -> dict:
    """What ``exp_mode7_r4.py::_flush`` writes for ``rows``: the per-method
    mean and std of budget, PSNR, SSIM and path length, and PRV's deltas
    against mode, median, mean and gt with their SEMs (4 decimals)."""
    summary = {}
    methods = sorted({k for e in rows.values() for k in e})
    for m in methods:
        recs = [e[m] for e in rows.values() if m in e]
        for k in ("budget", "PSNR", "SSIM", "path_len"):
            v = np.array([r[k] for r in recs], dtype=np.float64)
            summary.setdefault(m, {})[k] = {
                "mean": round(float(v.mean()), 4),
                "std": round(float(v.std(ddof=1)) if len(v) > 1 else 0.0, 4),
            }
    deltas = {}
    if "prv" in methods:
        for m in BASELINES:
            if m not in methods:
                continue
            both = [e for e in rows.values() if "prv" in e and m in e]
            dp = [e["prv"]["PSNR"] - e[m]["PSNR"] for e in both]
            dl = [e["prv"]["path_len"] - e[m]["path_len"] for e in both]
            deltas[f"prv_vs_{m}"] = {"dPSNR_mean": round(float(np.mean(dp)), 4), "dPSNR_sem": _sem(dp),
                                     "dpath_mean": round(float(np.mean(dl)), 4), "dpath_sem": _sem(dl)}
    return {"n_done": len(rows), "n_roster": n_roster, "stat_budgets": stat_budgets, "val_n": val_n,
            "summary": summary, "deltas": deltas, "rows": rows}
