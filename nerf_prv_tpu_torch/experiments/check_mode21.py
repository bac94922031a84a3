"""The mode-21 check: the port's five-method view-planning table on the
held-out roster against the JAX package's committed ``mode21_r4.json``.

    python -m nerf_prv_tpu_torch.experiments.check_mode21 [--objects clu10 ...] [--methods 4 0 1 2 3]
        [--workers 6] [--live]

On the card, for the five objects of ``pick_objects(5)`` and methods 4, 0, 1,
2 and 3 at the committed budgets (method 4 through ``PinnedPredictor``
holding the committed method-4 budgets; methods 0-3 replay its
``view_budget.txt``):
1. each object's method 4 (every object at once, in ``--workers``
   processes), then its other methods, one process each;
2. per row: the port's budget, views trained, movement, PSNR and SSIM
   beside the committed ones.  Held: the budget and the views trained equal,
   the movement of methods 4, 0 and 1 equal to its stored 4 decimals; PSNR
   and SSIM against the mode-7 check's L (``results/mode7_check.json``,
   written before this check runs).  The ensemble methods' movement is
   recorded without a limit.

A row is done once it has a PSNR and is not run again: the rows resume from
the result file, so the table can be split over calls by ``--objects`` and
``--methods``.  The workspace does not outlive a call, so an object's method
4 runs again (its first row kept) wherever a later call needs its
``view_budget.txt``.

``--live`` runs methods 4, 0 and 1 at the budgets of the port's own
predictor (``results/prv_budgets.json``) and writes the rows and their
summary beside the committed ones into that file.

The workspace is ``.workspace/mode21_check``, the result
``nerf_prv_tpu_torch/experiments/results/mode21_check.json``; the log and a
copy go to the gitignored ``runs.LOG_DIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from .families import make_family_object
from .label_protocol import model_dir, require_device
from .mode7_compare import install_eval_viewspace
from .mode21_table import (
    METHODS, PinnedPredictor, committed, mode21_config, pick_objects, run_rows, summarize, total_movement,
)
from .runs import LOG_DIR, RESULTS_DIR, WORKSPACE, Log, build_kernels, card_line, run_jobs, write_json

EXACT_MOVEMENT = (4, 0, 1)  # deterministic given the view space and the budget
PRV_BUDGETS = os.path.join(RESULTS_DIR, "prv_budgets.json")
MODE7_CHECK = os.path.join(RESULTS_DIR, "mode7_check.json")


def rows_job(job: tuple) -> dict:
    """(root, name, methods, budgets, device): the object's rows for
    ``methods`` in a worker process, with its wall."""
    import torch

    root, name, methods, budgets, device = job
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    cfg = mode21_config(root)
    rows = run_rows(cfg, [name], methods, PinnedPredictor(budgets), device=device)
    for m in methods:  # the unrounded total beside the row's 4 decimals
        path = f"{cfg.replace(name_of_pcd=name, method_of_IG=m).save_path}_v3_t0"
        rows[f"{name}/m{m}"]["movement_full"] = total_movement(path)
    return dict(name=name, methods=list(methods), rows=rows, wall_s=time.perf_counter() - t0)


def check_row(row: dict, ref: dict, method: int, limit: dict) -> dict:
    """The held quantities of one row against the committed row."""
    out = dict(n_views_equal=row.get("n_views_trained") == ref.get("n_views_trained"))
    if "budget" in ref:
        out["budget_equal"] = row.get("budget") == ref["budget"]
    out["movement_diff"] = row.get("movement", float("nan")) - ref["movement"]
    if method in EXACT_MOVEMENT:
        out["movement_equal"] = row.get("movement") == ref["movement"]
    out["dPSNR"] = row["PSNR"] - ref["PSNR"]
    out["dSSIM"] = row["SSIM"] - ref["SSIM"]
    if limit:
        out["psnr_within_L"] = abs(out["dPSNR"]) <= limit["L_psnr"]
        out["ssim_within_L"] = abs(out["dSSIM"]) <= limit["L_ssim"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--objects", nargs="+", default=None)
    ap.add_argument("--methods", type=int, nargs="+", default=None)
    ap.add_argument("--root", default=None)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--live", action="store_true", help="budgets from results/prv_budgets.json")
    ap.add_argument("--out", default=None)
    ap.add_argument("--log", default=None)
    args = ap.parse_args(argv)
    tag = "mode21_live" if args.live else "mode21_check"
    root = args.root or os.path.join(WORKSPACE, tag)
    out_path = args.out or (PRV_BUDGETS if args.live else os.path.join(RESULTS_DIR, "mode21_check.json"))
    log = Log(args.log or os.path.join(LOG_DIR, f"{tag}.log"))
    device = require_device(args.device)
    card = card_line()
    ref = committed()
    objects = args.objects or pick_objects(5)
    methods = args.methods or ((4, 0, 1) if args.live else METHODS)
    log(f"{tag} on {card}; objects {objects}, methods {methods}, workspace {root}, {args.workers} workers")

    if args.live:
        with open(out_path) as f:
            full = json.load(f)
        budgets = {n: int(b) for n, b in full["budgets"].items()}
        result = full.setdefault("mode21", {})
    else:
        budgets = {n: ref["rows"][f"{n}/m4"]["budget"] for n in ref["objects"]}
        full = result = {}
        if os.path.exists(out_path):
            with open(out_path) as f:
                full = result = json.load(f)
    result.setdefault("objects", pick_objects(5))
    result.setdefault("methods", list(METHODS))
    result["budgets"] = budgets
    result["protocol"] = dict(ref["protocol"], workers=args.workers, predictor="PinnedPredictor")
    result.setdefault("cards", [])
    if card not in result["cards"]:
        result["cards"].append(card)
    result.setdefault("rows", {})
    result.setdefault("reruns", {})

    def save():
        summarize(result)
        write_json(out_path, full, LOG_DIR)

    def take(rec):
        for key, row in rec["rows"].items():
            if key in result["rows"] and "PSNR" in result["rows"][key]:
                result["reruns"].setdefault(key, []).append(row)
            else:
                result["rows"][key] = row
            log(f"{key}: {row}")
        save()

    todo = {n: [m for m in methods if "PSNR" not in result["rows"].get(f"{n}/m{m}", {})] for n in objects}
    todo = {n: ms for n, ms in todo.items() if ms}
    build_kernels(device)
    cfg = mode21_config(root)
    install_eval_viewspace(cfg)
    for name in todo:
        make_family_object(name, model_dir(cfg))
    t0 = time.perf_counter()
    # method 4 first: the other methods replay its view_budget.txt
    jobs = [(root, n, (4,), budgets, str(device)) for n in todo]
    for rec in run_jobs(rows_job, jobs, args.workers):
        take(rec)
    rest = sorted(((n, m) for n, ms in todo.items() for m in ms if m != 4), key=lambda nm: -nm[1])
    jobs = [(root, n, (m,), budgets, str(device)) for n, m in rest]
    for rec in run_jobs(rows_job, jobs, args.workers):
        take(rec)
    result.setdefault("calls", []).append(dict(card=card, objects=list(todo), methods=list(methods),
                                               wall_s=time.perf_counter() - t0))

    if args.live:
        result["committed_summary"] = ref["summary"]
        save()
        log(f"live mode 21 ({card}): {json.dumps(result['summary'])}; committed {json.dumps(ref['summary'])}")
        return 0
    limit = {}
    if os.path.exists(MODE7_CHECK):
        with open(MODE7_CHECK) as f:
            lim = json.load(f).get("limit", {})
        limit = {k: lim[k] for k in ("L_psnr", "L_ssim") if k in lim}
    result["limit"] = dict(limit, source="results/mode7_check.json")
    checks = {}
    for key, row in result["rows"].items():
        if "PSNR" in row and key in ref["rows"]:
            checks[key] = check_row(row, ref["rows"][key], int(key.rsplit("/m", 1)[1]), limit)
    result["checks"] = checks
    held = [c.get(k, True) for c in checks.values() for k in ("n_views_equal", "budget_equal", "movement_equal")]
    result["check_summary"] = dict(
        n_rows=len(checks), n_rows_committed=len(ref["rows"]), held_equal=all(held),
        misses=[k for k, c in checks.items()
                if not all(c.get(x, True) for x in ("n_views_equal", "budget_equal", "movement_equal"))],
        psnr_within_L=sum(c.get("psnr_within_L", False) for c in checks.values()),
        ssim_within_L=sum(c.get("ssim_within_L", False) for c in checks.values()),
        committed_summary=ref["summary"],
    )
    save()
    log(f"summary ({card}): {json.dumps(result['check_summary'])}")
    log(f"table: {json.dumps(result['summary'])}")
    return 0 if result["check_summary"]["held_equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
