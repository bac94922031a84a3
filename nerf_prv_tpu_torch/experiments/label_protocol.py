"""The PRV corpus's label protocol on the port: modes 0 -> 3 -> 4 -> fit.

Counterpart of ``experiments/exp_label_spread.py`` (``pipeline_config``,
``run_label_protocol``): each object is rendered as coverage sets of 3..47
views step 4 and 100 views at a 320x180 model-0 camera, a 1,200-step voxel
NeRF is trained on each set and scored on the 100-view set, the lognormal
fit of the PSNR curve gives ``label.txt``, and the label is the
gradient@0.02 view count (``gradient_labels[1]``, ≙ main.cpp:2641).

View spaces.  The port's hemisphere generator draws its start points with a
``torch.Generator`` where the reference draws them with ``jax.random``, so
one seed gives other (equally packed) view spaces.  To hold the port's
labels against the reference's, the view-space files the reference's
workspace held are shipped with this package (``viewspace/``, written by the
JAX package's ``generate_hemisphere`` on the CPU): mode 0's ``<n>.txt``
(``generate_hemisphere(n, seed=n)``) and, in ``viewspace/probe``, the 5-view
size-test space that the reference's ``load_object`` writes when mode 0 has
not (``generate_hemisphere(5, seed=0)``).  ``viewspace/seed0`` holds the
sizes 6..60 that mode 0 did not write, as the reference's
``_ensure_viewspace`` writes them on demand (``generate_hemisphere(n)``,
seed 0): the budgets of the held-out evaluation (``mode7_compare``,
``mode21_table``).  :func:`install_reference_viewspace` copies them into a
workspace; mode 0 then finds them and generates only what is still missing.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.config import CameraConfig, Config
from ..labeling.labels import parse_label_file
from ..nerf.model import NerfConfig
from ..pipeline import modes
from .families import make_family_object

VIEWSPACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "viewspace")
ON_DEMAND_DIR = os.path.join(VIEWSPACE_DIR, "seed0")  # sizes the reference wrote with seed 0
LABEL_INDEX = 1  # gradient@0.02 dB/view (≙ main.cpp:2641)
LABEL_GRADIENT = 0.02


def pipeline_config(root: str) -> Config:
    """The protocol's configuration under ``root`` (≙ exp_label_spread.py:43-58):
    the 320x180 model-0 camera, 1,200 NeRF steps, fit counts 3..47 step 4
    (+ 100 for the maximum)."""
    cam = CameraConfig(width=320, height=180, fx=228.9, fy=228.3, ppx=161.8, ppy=93.1, model=0)
    return Config(
        workspace=os.path.join(root, "ws"),
        model_path=os.path.join(root, "models"),
        viewspace_path=os.path.join(root, "ws", "viewspace"),
        name_of_pcd="uni0",
        coverage_view_num_max=47,
        coverage_view_num_add=4,  # 12 fit counts 3,7,..,47 (+100 for max)
        n_steps=1200,
        camera=cam,
    )


def fit_counts(cfg: Config) -> List[int]:
    """The view counts the label is fit on (the coverage counts less 100)."""
    return [n for n in modes._coverage_counts(cfg) if n != 100]


def install_reference_viewspace(cfg: Config, sizes: Sequence[int], probe: bool) -> None:
    """Copy the reference's view-space files for ``sizes`` into
    ``cfg.viewspace_path`` where missing: mode 0's file of a size where it
    wrote one, else the on-demand one (``ON_DEMAND_DIR``).  ``probe`` adds
    the size test's 5-view file as the reference's ``load_object`` writes it
    (when 5 is not among mode 0's sizes).  The shipped files are the
    reference's at ``cfg.seed == 0`` only."""
    if cfg.seed != 0:
        raise ValueError(f"the shipped view spaces are the reference's at seed 0, not {cfg.seed}")
    os.makedirs(cfg.viewspace_path, exist_ok=True)
    files = []
    for n in sizes:
        src = os.path.join(VIEWSPACE_DIR, f"{n}.txt")
        files.append((src if os.path.exists(src) else os.path.join(ON_DEMAND_DIR, f"{n}.txt"), f"{n}.txt"))
    if probe:
        files.append((os.path.join(VIEWSPACE_DIR, "probe", "5.txt"), "5.txt"))
    for src, name in files:
        dst = os.path.join(cfg.viewspace_path, name)
        if not os.path.exists(dst):
            shutil.copyfile(src, dst)


def model_dir(cfg: Config) -> str:
    return os.path.join(cfg.model_path, "ShapeNet")


def require_device(device) -> torch.device:
    """``device`` as a torch device; raises for a card that is not there
    (the CPU is run only when asked for)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def seed_workspace(cfg: Config, seed: int) -> Config:
    """The workspace a NeRF seed other than 0 trains in (its own metric and
    label files beside the seed-0 ones; view spaces and models shared)."""
    return cfg if seed == 0 else cfg.replace(workspace=f"{cfg.workspace}_seed{seed}")


def _instant_ngp_seeded(cfg: Config, name: str, nerf_cfg: NerfConfig, seed: int, device,
                        counts: Sequence[int] = None) -> None:
    """Mode 4's one-at-a-time loop (``pipeline/modes.py::mode_instant_ngp``,
    ``batch_size=1``) with the NeRF seed ``seed``: each count's field trained,
    scored on the 100-view set and written as ``<v>.txt``, skipped where the
    file exists.  ``counts`` picks some of mode 4's counts (default all)."""
    from ..nerf.api import eval_nerf, save_metrics, train_nerf
    from ..nerf.rays import load_dataset
    from ..pipeline.coverage import get_coverage
    from ..scene.object_setup import load_object

    obj_cfg = cfg.replace(name_of_pcd=name)
    scene = load_object(obj_cfg, name, device=device)
    if not scene.ok:
        return
    test_json = get_coverage(scene, obj_cfg, 100, device=device)
    test_ds = None
    for n in counts or modes._coverage_counts(obj_cfg):
        train_json = get_coverage(scene, obj_cfg, n, device=device)
        metrics_file = os.path.join(obj_cfg.gt_path, f"{n}.txt")
        if os.path.exists(metrics_file):
            continue
        test_ds = test_ds or load_dataset(test_json)
        params, _ = train_nerf(train_json, nerf_cfg, seed=seed, device=device)
        save_metrics(metrics_file, eval_nerf(params, test_ds, nerf_cfg))


def run_label_protocol(
    cfg: Config, names: Sequence[str], seed: int = 0, device="cuda", nerf_cfg: NerfConfig = None
) -> Tuple[Dict[str, Tuple[int, bool]], Dict[str, float]]:
    """Modes 0 -> 3 -> 4 -> lognormal fit for ``names`` (≙
    exp_label_spread.py:61-90); returns ({name: (label, converged)}, wall
    seconds per object).

    ``seed`` is the NeRF seed only: at 0 mode 4 runs as ``mode_instant_ngp``
    (one field at a time), otherwise its loop runs here with that seed, in a
    workspace of its own (:func:`seed_workspace`).  The view spaces and
    coverage sets stay those of ``cfg.seed``.  ``nerf_cfg`` defaults to
    ``NerfConfig(n_steps=cfg.n_steps)``, the reference's.  Every stage skips
    what its files say is done, so a run that was cut carries on.
    """
    device = require_device(device)
    for name in names:
        make_family_object(name, model_dir(cfg))
    modes.mode_view_cover(cfg, sizes=fit_counts(cfg) + [64, 100], device=device)
    cfg = seed_workspace(cfg, seed)
    nerf_cfg = nerf_cfg or NerfConfig(n_steps=cfg.n_steps)
    out, times = {}, {}
    for name in names:
        t0 = time.perf_counter()
        modes.mode_get_coverage(cfg, [name], device=device)
        if seed == 0:
            modes.mode_instant_ngp(cfg, [name], nerf_cfg=nerf_cfg, batch_size=1, device=device)
        else:
            _instant_ngp_seeded(cfg, name, nerf_cfg, seed, device)
        modes.mode_fit_labels(cfg, [name], device=device)
        res = parse_label_file(os.path.join(cfg.replace(name_of_pcd=name).gt_path, "label.txt"))
        label = int(res.gradient_labels[LABEL_INDEX])
        out[name] = (label, bool(res.converged))
        times[name] = time.perf_counter() - t0
        print(f"{name} (NeRF seed {seed}): label={label} converged={res.converged} ({times[name]:.1f}s)",
              flush=True)
    return out, times


def object_record(cfg: Config, name: str, seed: int = 0) -> dict:
    """What one object's run left in its folder: the label, the converged
    flag, each count's PSNR, and the fitted curve's gain (dB/view) at the
    label and one view before it, beside the 0.02 the label is decided at."""
    from ..nerf.api import load_metrics

    gt = seed_workspace(cfg, seed).replace(name_of_pcd=name).gt_path
    res = parse_label_file(os.path.join(gt, "label.txt"))
    label = int(res.gradient_labels[LABEL_INDEX])
    gains = np.diff(np.asarray(res.curve, np.float64))  # FitY(v) - FitY(v-1), v = 4..100
    rec = dict(
        label=label,
        converged=bool(res.converged),
        psnr={str(n): load_metrics(os.path.join(gt, f"{n}.txt"))["PSNR"] for n in modes._coverage_counts(cfg)},
    )
    if label >= 5:
        rec["gain_at_label"] = float(gains[label - 4])
        rec["gain_before_label"] = float(gains[label - 5])
    return rec


def protocol_job(job: tuple) -> dict:
    """One (root, name, seed, device) protocol run in a worker process:
    :func:`run_label_protocol` then :func:`object_record`, with its wall."""
    root, name, seed, device = job
    torch.set_num_threads(1)
    cfg = pipeline_config(root)
    t0 = time.perf_counter()
    run_label_protocol(cfg, [name], seed=seed, device=device)
    return dict(name=name, seed=seed, wall_s=time.perf_counter() - t0, **object_record(cfg, name, seed))
