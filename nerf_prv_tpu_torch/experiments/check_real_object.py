"""The real-object check: the port's production label protocol on the two
textured meshes against the JAX package's committed calibrations
(``experiments/artifacts/real_object_calibration{,_knot}.json``).

    python -m nerf_prv_tpu_torch.experiments.check_real_object [--workers 6]

In this order, on the card:
1. Fields.  The torus (counts 3, 5, ..., 49) and the knot (3, 9, ..., 45),
   each with its 100-view anchor, at NeRF seeds 0, 1 and 2: the mesh is
   sampled and mode 0's view spaces installed once, each seed's coverage sets
   rendered in its own workspace, then every (object, seed, count) field is a
   job of its own, ``--workers`` at a time (the training is host-bound, so
   several share the card), and each (object, seed) is fit by
   ``real_object.run_real_object``, which finds its fields done.
2. Limits, written to the result file and the log before any comparison:
   per object, the PSNR limit at each count is the seeds' range widened on
   each side by that object's largest per-count range; the label limit is
   the labels' range widened by one view on each side (the integer rounding).
3. Comparison, per object and seed: the PSNRs against the committed ones count
   by count and ``max_psnr_100``; the label; ``converged`` with its margins
   (the fitted curve's tail and the largest measured PSNR, each less the
   100-view PSNR: the fit is refused where a sample lies above it); the two
   shape flags.
4. Summary, per object: how many committed PSNRs lie within the limits,
   whether the committed label does, and the paired offset port - committed
   (each count's seed mean) with a two-sided sign test.

A miss fails nothing: it is recorded with its numbers.  The workspace is
``.workspace/real_object_check`` (every field is kept as its ``<v>.txt``, so a
cut call carries on), the result
``nerf_prv_tpu_torch/experiments/results/real_object_check.json``; the log
and a copy of the result go to the gitignored ``runs.LOG_DIR``.  Walls are
taken under the workers' sharing.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .check_mode7 import sign_test
from .label_protocol import _instant_ngp_seeded, fit_counts, require_device, seed_workspace
from .real_object import (
    KINDS, N_STEPS, SWEEPS, committed, object_name, prepare, real_object_config, run_real_object,
)
from .runs import (
    LOG_DIR, RESULTS_DIR, WORKSPACE, Log, build_kernels, card_line, restore_metrics, run_jobs, write_json,
)

SEEDS = (0, 1, 2)
ROUNDING = 1  # a view, for the integer label


def nerf_config():
    """The protocol's field: the default voxel field, ``N_STEPS`` steps."""
    from ..nerf.model import NerfConfig

    return NerfConfig(n_steps=N_STEPS)


def _config(root: str, kind: str):
    return real_object_config(kind, os.path.join(root, kind), *SWEEPS[kind])


def coverage_job(job: tuple) -> dict:
    """Mode 3 of one (root, kind, seed, device) in a worker process: the
    seed's workspace gets its own coverage sets (the same renders)."""
    import torch

    from ..pipeline import modes

    root, kind, seed, device = job
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    modes.mode_get_coverage(seed_workspace(_config(root, kind), seed), [object_name(kind)], device=device)
    return dict(kind=kind, seed=seed, wall_s=time.perf_counter() - t0)


def field_job(job: tuple) -> dict:
    """One (root, kind, seed, count, device) field in a worker process:
    trained, scored on the 100-view set, written as ``<count>.txt``."""
    import torch

    from ..nerf.api import load_metrics

    root, kind, seed, n, device = job
    torch.set_num_threads(1)
    work = seed_workspace(_config(root, kind), seed)
    t0 = time.perf_counter()
    _instant_ngp_seeded(work, object_name(kind), nerf_config(), seed, device, counts=[n])
    wall = time.perf_counter() - t0
    metrics = load_metrics(os.path.join(work.replace(name_of_pcd=object_name(kind)).gt_path, f"{n}.txt"))
    return dict(kind=kind, seed=seed, n=n, PSNR=metrics["PSNR"], SSIM=metrics["SSIM"], wall_s=wall)


def restore_fields(root: str, fields: dict) -> None:
    """The metric files of every field an earlier call recorded
    (``{"kind@seed": {"count": {PSNR, SSIM, wall_s}}}``), written back."""
    for key, per in fields.items():
        kind, seed = key.split("@")
        restore_metrics(seed_workspace(_config(root, kind), int(seed)).replace(name_of_pcd=object_name(kind)).gt_path,
                        per)


def seed_limits(runs: dict, seeds) -> dict:
    """Per count (and 100): the seeds' PSNR range widened on each side by
    the object's largest per-count range; the label range widened by the
    rounding view."""
    per = {k: [_by_count(runs[s])[k] for s in seeds] for k in _by_count(runs[seeds[0]])}
    ranges = {k: max(v) - min(v) for k, v in per.items()}
    widen = max(ranges.values())
    labels = [runs[s]["gradient_label_0.02"] for s in seeds]
    return dict(
        psnr={k: [min(v) - widen, max(v) + widen] for k, v in per.items()}, widen_db=widen, ranges_db=ranges,
        label=[min(labels) - ROUNDING, max(labels) + ROUNDING], labels=labels,
        rule=f"PSNR at each count: [min, max] over NeRF seeds {list(seeds)} widened on each side by the object's "
             f"largest per-count range; label: [min, max] widened by {ROUNDING} view",
    )


def converged_margins(art: dict) -> dict:
    """The fitted curve's tail and the largest measured PSNR, each less the
    100-view PSNR (the fit is refused where a sample lies above it)."""
    return dict(tail_minus_max_db=art["fitted_curve_3_100"][-1] - art["max_psnr_100"],
                sample_minus_max_db=max(art["measured_psnr"]) - art["max_psnr_100"])


def _by_count(art: dict) -> dict:
    """{"count": PSNR} of an artifact, the 100-view one under "100"."""
    return {**{str(v): p for v, p in zip(art["view_counts"], art["measured_psnr"])}, "100": art["max_psnr_100"]}


def compare_run(port: dict, ref: dict) -> dict:
    """One seed's run against the committed one, count by count where both
    scored the count."""
    got, want = _by_count(port), _by_count(ref)
    return dict(
        psnr_diff_db={k: round(p - want[k], 3) for k, p in got.items() if k in want},
        label=port["gradient_label_0.02"], committed_label=ref["gradient_label_0.02"],
        converged=port["converged"], committed_converged=ref["converged"],
        margins=converged_margins(port), committed_margins=converged_margins(ref),
        curve_monotone=[port["curve_monotone"], ref["curve_monotone"]],
        curve_diminishing_returns=[port["curve_diminishing_returns"], ref["curve_diminishing_returns"]],
        curve_max_diff_db=float(np.abs(np.subtract(port["fitted_curve_3_100"], ref["fitted_curve_3_100"])).max()),
    )


def summarize(runs: dict, ref: dict, limits: dict, seeds) -> dict:
    """Per object: the committed PSNRs within the limits, the committed label
    within its limit, the paired offset (each count's seed mean less the
    committed PSNR) and its sign test, over the counts both scored."""
    want = _by_count(ref)
    keys = [k for k in _by_count(runs[seeds[0]]) if k in want]
    within = {k: limits["psnr"][k][0] <= want[k] <= limits["psnr"][k][1] for k in keys}
    diffs = [float(np.mean([_by_count(runs[s])[k] for s in seeds])) - want[k] for k in keys]
    lo, hi = limits["label"]
    return dict(
        n_counts=len(keys), n_within=sum(within.values()), outside=[k for k in keys if not within[k]],
        label_within=lo <= ref["gradient_label_0.02"] <= hi,
        offset_db=float(np.mean(diffs)), offset_sem_db=float(np.std(diffs, ddof=1) / np.sqrt(len(diffs))),
        sign_test=sign_test(diffs),
        converged=[runs[s]["converged"] for s in seeds], committed_converged=ref["converged"],
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(WORKSPACE, "real_object_check"))
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--objects", nargs="*", default=list(KINDS), choices=KINDS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "real_object_check.json"))
    ap.add_argument("--log", default=os.path.join(LOG_DIR, "real_object_check.log"))
    args = ap.parse_args(argv)
    device = require_device(args.device)
    log = Log(args.log)
    card = card_line()
    log(f"real-object check on {card}; workspace {args.root}, {args.workers} workers, objects {args.objects}")
    build_kernels(device)
    from ..scene.object_setup import _ensure_viewspace

    result = dict(card=card, protocol=dict(
        camera="1280x720 model 2 (CameraConfig())", n_steps=N_STEPS, seeds=list(SEEDS), label="gradient@0.02",
        sweeps={k: fit_counts(_config(args.root, k)) for k in KINDS}), calls=[], prepare={}, coverage={},
        fields={}, runs={}, limits={}, comparison={}, summary={})
    if os.path.exists(args.out):  # an earlier call's fields: their metric files go back into the workspace
        with open(args.out) as f:
            prior = json.load(f)
        if prior.get("protocol") == result["protocol"]:
            result = prior
            restore_fields(args.root, result["fields"])
    result["calls"].append(dict(card=card, objects=args.objects, workers=args.workers))
    for kind in args.objects:
        t0 = time.perf_counter()
        cfg = _config(args.root, kind)
        prepare(kind, os.path.join(args.root, kind), cfg, fit_counts(cfg), device)
        _ensure_viewspace(cfg.viewspace_path, cfg.num_of_views, device)
        result["prepare"][kind] = dict(wall_s=time.perf_counter() - t0)
        log(f"{kind}: sampled, view spaces installed, {time.perf_counter() - t0:.1f} s")
    jobs = [(args.root, k, s, str(device)) for k in args.objects for s in SEEDS]
    for rec in run_jobs(coverage_job, jobs, args.workers):
        result["coverage"][f"{rec['kind']}@{rec['seed']}"] = rec["wall_s"]
        log(f"{rec['kind']} seed {rec['seed']}: coverage sets rendered in {rec['wall_s']:.1f} s")
    write_json(args.out, result, LOG_DIR)

    jobs = []
    for kind in args.objects:
        for s in SEEDS:
            gt = seed_workspace(_config(args.root, kind), s).replace(name_of_pcd=object_name(kind)).gt_path
            jobs += [(args.root, kind, s, n, str(device)) for n in [100] + fit_counts(_config(args.root, kind))
                     if not os.path.exists(os.path.join(gt, f"{n}.txt"))]
    log(f"{len(jobs)} fields to train")
    t_fields = time.perf_counter()
    for rec in run_jobs(field_job, jobs, args.workers):
        result["fields"].setdefault(f"{rec['kind']}@{rec['seed']}", {})[str(rec["n"])] = dict(
            PSNR=rec["PSNR"], SSIM=rec["SSIM"], wall_s=rec["wall_s"])
        write_json(args.out, result, LOG_DIR)
        log(f"{rec['kind']} seed {rec['seed']} at {rec['n']} views: PSNR {rec['PSNR']:.3f} dB, {rec['wall_s']:.1f} s")
    result["calls"][-1].update(fields_wall_s=time.perf_counter() - t_fields, n_fields=len(jobs))

    for kind in args.objects:
        for s in SEEDS:
            art, walls = run_real_object(kind, os.path.join(args.root, kind), None, *SWEEPS[kind], seed=s,
                                         device=device, nerf_cfg=nerf_config())
            result["runs"][f"{kind}@{s}"] = dict(art, walls=walls)
    write_json(args.out, result, LOG_DIR)

    runs = {k: {s: result["runs"][f"{k}@{s}"] for s in SEEDS} for k in args.objects}
    result["limits"].update({k: seed_limits(runs[k], SEEDS) for k in args.objects})
    write_json(args.out, result, LOG_DIR)
    for k in args.objects:
        lim = result["limits"][k]
        log(f"LIMITS written before the comparison, {k}: PSNR widened by {lim['widen_db']:.3f} dB at each count; "
            f"label [{lim['label'][0]}, {lim['label'][1]}] (labels {lim['labels']})")

    for k in args.objects:
        ref = committed(k)
        result["comparison"][k] = {str(s): compare_run(runs[k][s], ref) for s in SEEDS}
        result["summary"][k] = summarize(runs[k], ref, result["limits"][k], SEEDS)
    result["calls"][-1]["wall_s"] = time.perf_counter() - log.t0
    write_json(args.out, result, LOG_DIR)
    for k in args.objects:
        for s, c in result["comparison"][k].items():
            log(f"{k} seed {s}: label {c['label']} (committed {c['committed_label']}), converged {c['converged']} "
                f"(committed {c['committed_converged']}; tail - max {c['margins']['tail_minus_max_db']:+.3f}, "
                f"largest sample - max {c['margins']['sample_minus_max_db']:+.3f} dB), shape flags "
                f"{c['curve_monotone']} {c['curve_diminishing_returns']}")
        log(f"summary {k} ({card}): {json.dumps(result['summary'][k])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
