"""The warm-start study on the port: does mode 4 need 2,500 from-scratch
steps at every view count?

Counterpart of ``experiments/exp_warmstart.py``: ``toy0`` at the default
``Config`` (the 1280x720 model-2 camera, 2,500-step fields of the default
voxel field), the view counts 3..49 step 2 and 100, through the port's
``mode_instant_ngp`` in three arms:
- ``scratch``: every count from scratch (the reference's protocol);
- ``warm800`` / ``warm400``: the first count from scratch, then each count
  from the previous count's field for 800 / 400 steps
  (``warm_start_steps``).
Per arm: the wall of ``mode_instant_ngp``, the PSNR at every count, the
lognormal fit's ``converged``, gap and gradient labels and curve.  Each warm
arm against scratch (``:84-91``): the speedup (scratch wall over the arm's),
max |dPSNR| over the counts, max |dcurve| and |d grad@0.02|.

The view spaces are mode 0's files the reference's workspace held (shipped
with this package, ``real_object.install_production_viewspace``).  The
coverage sets are rendered once into ``<root>/ws`` and each arm trains in a
workspace of its own (``<root>/ws_<arm>``) with them copied in, so that an
arm's wall holds only ``mode_instant_ngp`` and arms can run in separate
calls: a call renders the sets anew (the same files, the same pixels).

    python -m nerf_prv_tpu_torch.experiments.warmstart [--arms scratch warm800 warm400]

The result ``nerf_prv_tpu_torch/experiments/results/warmstart.json`` keeps
each arm as it finishes; the summary is written once all three are in.  The
log and a copy go to the gitignored ``runs.LOG_DIR``.  Run one arm at a time
on the card: the speedup is the study's figure.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Dict

import numpy as np

from ..core.config import Config
from ..pipeline import modes
from .label_protocol import require_device
from .real_object import install_production_viewspace
from .runs import LOG_DIR, RESULTS_DIR, WORKSPACE, Log, build_kernels, card_line, write_json
from .toy import TOY_NAME, write_toy

COUNTS = list(range(3, 51, 2))
PROBE_COUNTS = (3, 13, 25, 49, 100)
ARMS = {"scratch": 0, "warm800": 800, "warm400": 400}
# the JAX run's finding (experiments/README.md:45)
JAX_RECORD = ("warm-starting each count from the previous one: 1.27-1.44x end to end over the 3..49 step 2 + 100 "
              "sweep; the gradient@0.02 label moves by 2-3 views; warm800 broke the lognormal fit's convergence")


def warmstart_config(root: str) -> Config:
    """The script's configuration under ``root`` (≙ exp_warmstart.py:49-55)."""
    return Config(
        workspace=os.path.join(root, "ws"),
        model_path=os.path.join(root, "models"),
        viewspace_path=os.path.join(root, "ws", "viewspace"),
        name_of_pcd=TOY_NAME,
        n_steps=2500,
    )


def arm_config(cfg: Config, arm: str) -> Config:
    """The arm's own workspace; the model files and view spaces shared."""
    return cfg.replace(workspace=f"{cfg.workspace}_{arm}")


def prepare(root: str, device="cuda") -> Config:
    """``toy0``'s PLY, mode 0 (the shipped files) and mode 3 for every
    count (≙ exp_warmstart.py:56-60)."""
    cfg = warmstart_config(root)
    write_toy(root)
    sizes = COUNTS + [100]
    install_production_viewspace(cfg, sizes)
    modes.mode_view_cover(cfg, sizes=sizes, device=device)
    modes.mode_get_coverage(cfg, [TOY_NAME], device=device)
    return cfg


def run_arm(cfg: Config, arm: str, device="cuda") -> dict:
    """One arm in its own workspace: the coverage sets copied in with no
    metric or label file, then ``mode_instant_ngp`` timed and the fit
    (≙ exp_warmstart.py:64-79)."""
    from ..labeling.labels import fit_object_from_metrics
    from ..nerf.api import load_metrics

    src = cfg.gt_path
    acfg = arm_config(cfg, arm)
    gt = acfg.gt_path
    if os.path.exists(gt):
        shutil.rmtree(gt)
    shutil.copytree(src, gt, ignore=lambda d, names: [n for n in names if d == src and
                                                      (n == "label.txt" or n[:-4].isdigit() and n.endswith(".txt"))])
    t0 = time.perf_counter()
    modes.mode_instant_ngp(acfg, [TOY_NAME], warm_start_steps=ARMS[arm], device=device)
    wall = time.perf_counter() - t0
    counts = [n for n in modes._coverage_counts(acfg) if n != 100]
    psnr = {str(v): load_metrics(os.path.join(gt, f"{v}.txt"))["PSNR"] for v in counts + [100]}
    fit = fit_object_from_metrics(gt, counts, device=device)
    return dict(arm=arm, warm_start_steps=ARMS[arm], wall_s=wall, psnr=psnr, converged=bool(fit.converged),
                gap_labels=[int(v) for v in np.asarray(fit.gap_labels)],
                gradient_labels=[int(v) for v in np.asarray(fit.gradient_labels)],
                curve=[float(v) for v in np.asarray(fit.curve)])


def compare_arms(base: dict, arm: dict) -> dict:
    """A warm arm against scratch (≙ exp_warmstart.py:84-91)."""
    return dict(speedup=base["wall_s"] / arm["wall_s"],
                max_abs_dpsnr=max(abs(arm["psnr"][v] - base["psnr"][v]) for v in base["psnr"]),
                max_abs_dcurve=float(np.abs(np.asarray(arm["curve"]) - np.asarray(base["curve"])).max()),
                abs_d_grad_002=int(abs(arm["gradient_labels"][1] - base["gradient_labels"][1])))


def summarize(arms: Dict[str, dict]) -> dict:
    return {a: compare_arms(arms["scratch"], arms[a]) for a in ARMS if a != "scratch" and a in arms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arms", nargs="+", choices=list(ARMS), default=list(ARMS))
    ap.add_argument("--root", default=os.path.join(WORKSPACE, "warmstart"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "warmstart.json"))
    ap.add_argument("--log", default=os.path.join(LOG_DIR, "warmstart.log"))
    args = ap.parse_args(argv)
    device = require_device(args.device)
    log = Log(args.log)
    card = card_line()
    result = dict(card=card, cards=[card], counts=COUNTS + [100], jax_record=JAX_RECORD, arms={})
    if os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        result.update(arms=prev.get("arms", {}), calls=prev.get("calls", []),
                      cards=sorted(set(prev.get("cards", [])) | {card}))
    build_kernels(device)
    t0 = time.perf_counter()
    cfg = prepare(args.root, device)
    prep_s = time.perf_counter() - t0
    log(f"warm-start study on {card}: arms {args.arms}; view spaces and coverage {prep_s:.1f} s")
    for arm in args.arms:
        rec = run_arm(cfg, arm, device)
        rec["card"] = card
        result["arms"][arm] = rec
        write_json(args.out, result, LOG_DIR)
        probe = "  ".join(f"P{v}={rec['psnr'][str(v)]:.2f}" for v in PROBE_COUNTS)
        log(f"{arm:8s} {rec['wall_s']:7.1f}s  conv={rec['converged']}  {probe}\n"
            f"         gap={rec['gap_labels']}\n         grad={rec['gradient_labels']}")
    result.setdefault("calls", []).append(dict(card=card, arms=args.arms, prepare_s=prep_s))
    result["summary"] = summarize(result["arms"])
    write_json(args.out, result, LOG_DIR)
    for arm, s in result["summary"].items():
        log(f"{arm}: speedup {s['speedup']:.2f}x  max|dPSNR|={s['max_abs_dpsnr']:.2f}  "
            f"max|dcurve|={s['max_abs_dcurve']:.2f}  |d grad@0.02|={s['abs_d_grad_002']}")
    log(f"the JAX run's record: {JAX_RECORD}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
