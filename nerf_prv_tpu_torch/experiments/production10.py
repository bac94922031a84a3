"""The production label protocol over 10 family objects on the port, with
mode 5's label statistics and the seconds per protocol unit.

Counterpart of ``experiments/exp_production10.py``: modes 0 -> 3 -> 4 -> fit
-> 5 at the ``Config`` defaults (the 1280x720 inverse-Brown-Conrady camera,
counts 3..49 step 2 + the 100-view set, 2,500-step voxel fields), over 8
families' mid-hardness members and the two pilot-2 tail anchors.  A protocol
unit is one count's field: trained, then scored on the 100 views at 1280x720.

    python -m nerf_prv_tpu_torch.experiments.production10 --names uni5 --workers 1
    python -m nerf_prv_tpu_torch.experiments.production10 --names ell5 clu5 ... --workers 6

With ``--workers 1`` each object runs alone, as the reference's script runs
them (mode 3, then ``mode_instant_ngp``, then the fit): its
``s_per_protocol_unit`` is the card's own.  With more workers, every
object's coverage sets are rendered in parallel and then every (object,
count) field is a job of its own, that many at a time on the one card; an
object's ``ngp_sweep_s`` is then the sum of its fields' walls under that
sharing, and its ``seconds`` entry says so (``workers``).

The result ``nerf_prv_tpu_torch/experiments/results/production10.json`` has
the reference's keys, plus the card, each field's metrics and, per object,
the workers it shared the card with.  ``--names`` splits the objects over
calls: the objects of earlier calls stay in the file, and their metric files
are written back into the (new) workspace, so the fit and mode 5 run over
every object done so far.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..core.config import Config
from ..labeling.labels import parse_label_file
from ..nerf.model import NerfConfig
from ..pipeline import modes
from .families import make_family_object
from .label_protocol import LABEL_INDEX, _instant_ngp_seeded, fit_counts, model_dir, require_device
from .real_object import install_production_viewspace
from .runs import (
    LOG_DIR, RESULTS_DIR, WORKSPACE, Log, build_kernels, card_line, restore_metrics, run_jobs, write_json,
)

NAMES = ("uni5", "ell5", "clu5", "cup5", "pla5", "spi5", "van5", "box5", "nos5", "fan5")
CAMERA = "1280x720 inverse-Brown-Conrady (production default)"


def production_config(root: str) -> Config:
    """The reference's configuration under ``root`` (≙ exp_production10.py:
    43-48): every protocol setting at its default."""
    return Config(
        workspace=os.path.join(root, "ws"),
        model_path=os.path.join(root, "models"),
        viewspace_path=os.path.join(root, "ws", "viewspace"),
        name_of_pcd=NAMES[0],
    )


def nerf_config(cfg: Config) -> NerfConfig:
    """Mode 4's field: the default voxel field, ``cfg.n_steps`` steps."""
    return NerfConfig(n_steps=cfg.n_steps)


def jsonable(o):
    """``o`` with numpy scalars (dict keys too: mode 5's distributions are
    keyed by numpy ints) made plain Python."""
    if isinstance(o, dict):
        return {(int(k) if isinstance(k, np.integer) else k): jsonable(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [jsonable(v) for v in o]
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return o


def prepare(root: str, names, device) -> Config:
    """The objects' PLYs and mode 0's view spaces (the shipped files)."""
    cfg = production_config(root)
    for name in names:
        make_family_object(name, model_dir(cfg))
    sizes = fit_counts(cfg) + [100]
    install_production_viewspace(cfg, sizes)
    modes.mode_view_cover(cfg, sizes=sizes, device=device)
    return cfg


def run_alone(cfg: Config, name: str, device) -> dict:
    """One object as the reference's loop runs it (≙ exp_production10.py:
    58-76): mode 3, mode 4 over every count, the fit; the walls."""
    nerf_cfg = nerf_config(cfg)
    t0 = time.perf_counter()
    modes.mode_get_coverage(cfg, [name], device=device)
    t_cov = time.perf_counter() - t0
    t1 = time.perf_counter()
    modes.mode_instant_ngp(cfg, [name], nerf_cfg=nerf_cfg, device=device)
    t_ngp = time.perf_counter() - t1
    modes.mode_fit_labels(cfg, [name], device=device)
    return dict(total_s=time.perf_counter() - t0, coverage_s=t_cov, ngp_sweep_s=t_ngp)


def coverage_job(job: tuple) -> dict:
    """Mode 3 of one (root, name, device) in a worker process."""
    import torch

    root, name, device = job
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    modes.mode_get_coverage(production_config(root), [name], device=device)
    return dict(name=name, wall_s=time.perf_counter() - t0)


def field_job(job: tuple) -> dict:
    """One (root, name, count, device) field in a worker process: trained
    (NeRF seed 0, as mode 4), scored on the 100-view set, written."""
    import torch

    from ..nerf.api import load_metrics

    root, name, n, device = job
    torch.set_num_threads(1)
    cfg = production_config(root)
    t0 = time.perf_counter()
    _instant_ngp_seeded(cfg, name, nerf_config(cfg), 0, device, counts=[n])
    wall = time.perf_counter() - t0
    m = load_metrics(os.path.join(cfg.replace(name_of_pcd=name).gt_path, f"{n}.txt"))
    return dict(name=name, n=n, PSNR=m["PSNR"], SSIM=m["SSIM"], wall_s=wall)


def main(argv=None) -> int:
    import json

    from ..nerf.api import load_metrics

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--names", nargs="*", default=list(NAMES), choices=NAMES)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--root", default=os.path.join(WORKSPACE, "production10"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "production10.json"))
    ap.add_argument("--log", default=os.path.join(LOG_DIR, "production10.log"))
    args = ap.parse_args(argv)
    device = require_device(args.device)
    log = Log(args.log)
    card = card_line()
    log(f"production10 on {card}: {args.names}, {args.workers} workers, workspace {args.root}")
    build_kernels(device)
    result = dict(camera=CAMERA, n_steps=None, view_counts=None, objects={}, seconds={},
                  median_s_per_protocol_unit=None, label_stats_mode5=None, card=card, fields={})
    if os.path.exists(args.out):
        with open(args.out) as f:
            result.update(json.load(f), card=card)
    done = [n for n in NAMES if n in result["objects"] and n not in args.names]
    cfg = prepare(args.root, done + list(args.names), device)
    counts = fit_counts(cfg)
    result.update(n_steps=cfg.n_steps, view_counts=len(counts) + 1)
    for name in done + list(args.names):  # earlier calls' fields written back: the sweep skips them
        restore_metrics(cfg.replace(name_of_pcd=name).gt_path, result["fields"].get(name, {}))
    n_units = len(counts) + 1  # each count's field and the 100-view one

    def record(name: str, walls: dict, workers: int) -> None:
        gt = cfg.replace(name_of_pcd=name).gt_path
        res = parse_label_file(os.path.join(gt, "label.txt"))
        result["objects"][name] = {"label": int(res.gradient_labels[LABEL_INDEX]), "converged": bool(res.converged)}
        result["seconds"][name] = dict(walls, s_per_protocol_unit=walls["ngp_sweep_s"] / n_units, workers=workers,
                                       card=card)
        result["fields"].setdefault(name, {})
        for n in counts + [100]:
            m = load_metrics(os.path.join(gt, f"{n}.txt"))
            result["fields"][name].setdefault(str(n), dict(PSNR=m["PSNR"], SSIM=m["SSIM"]))
        log(f"{name}: label {result['objects'][name]['label']} converged {result['objects'][name]['converged']}, "
            f"{walls['total_s']:.1f} s, {result['seconds'][name]['s_per_protocol_unit']:.2f} s a unit "
            f"({workers} worker{'s' if workers > 1 else ''})")

    if args.workers <= 1:
        for name in args.names:
            record(name, run_alone(cfg, name, device), 1)
            write_json(args.out, jsonable(result), LOG_DIR)
    else:
        t0 = time.perf_counter()
        cov = {r["name"]: r["wall_s"] for r in run_jobs(
            coverage_job, [(args.root, n, str(device)) for n in args.names], args.workers)}
        log(f"coverage sets of {len(cov)} objects in {time.perf_counter() - t0:.1f} s: "
            + ", ".join(f"{n} {w:.1f} s" for n, w in cov.items()))
        jobs = [(args.root, name, n, str(device)) for name in args.names for n in [100] + counts
                if not os.path.exists(os.path.join(cfg.replace(name_of_pcd=name).gt_path, f"{n}.txt"))]
        walls = {n: 0.0 for n in args.names}
        for rec in run_jobs(field_job, jobs, args.workers):
            walls[rec["name"]] += rec["wall_s"]
            result["fields"].setdefault(rec["name"], {})[str(rec["n"])] = dict(
                PSNR=rec["PSNR"], SSIM=rec["SSIM"], wall_s=rec["wall_s"])
            write_json(args.out, jsonable(result), LOG_DIR)
            log(f"{rec['name']} at {rec['n']} views: PSNR {rec['PSNR']:.3f} dB, {rec['wall_s']:.1f} s")
        for name in args.names:
            modes.mode_fit_labels(cfg, [name], device=device)
            record(name, dict(total_s=cov[name] + walls[name], coverage_s=cov[name], ngp_sweep_s=walls[name]),
                   args.workers)
    modes.mode_fit_labels(cfg, done, device=device)
    names = [n for n in NAMES if n in result["objects"]]
    result["label_stats_mode5"] = modes.mode_read_label(cfg, names)
    units = [result["seconds"][n]["s_per_protocol_unit"] for n in names]
    result["median_s_per_protocol_unit"] = float(np.median(units))
    alone = {n: result["seconds"][n]["s_per_protocol_unit"] for n in names if result["seconds"][n]["workers"] == 1}
    result["s_per_protocol_unit_alone"] = alone
    write_json(args.out, jsonable(result), LOG_DIR)
    log(f"{len(names)} objects ({card}): labels {({n: result['objects'][n]['label'] for n in names})}; "
        f"s a unit alone {alone}, median {result['median_s_per_protocol_unit']:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
