"""The mode-7 check: the port's statistics comparison on the held-out roster
against the JAX package's committed ``mode7_r4.json``.

    python -m nerf_prv_tpu_torch.experiments.check_mode7 [--workers 6] [--live]

In this order, on the card:
1. Limit.  ``clu10`` and ``uni11`` at budget 28, NeRF seeds 0, 1 and 2.
   L_psnr is the larger of the two objects' three-seed PSNR ranges, doubled;
   L_ssim the same of SSIM.  Both, and the six fields' metrics, go to the
   result file and the log before any comparison is made.
2. Comparison.  The 10 test objects at their five committed budgets (gt,
   the val split's mode / median / mean, and the committed rows' PRV
   budgets, passed to ``compare_objects`` as ``predictions``).  Per distinct
   (object, budget): the port's PSNR, SSIM and path length, the committed
   ones and the wall.
3. Summary.  Every path length against the committed one (1e-9 relative);
   the share of PSNR and SSIM pairs within L; the mean port - committed
   PSNR with a two-sided sign test over the distinct pairs; ``summarize``'s
   deltas beside the committed ones (the path deltas equal, each dPSNR mean
   within 2 x the root-sum-square of the two SEMs).

``--live`` instead runs mode 7 at the PRV budgets of the port's own
predictor (``results/prv_budgets.json``, written by ``predict_budgets``) and
writes its table beside the committed one into that file; it has no limit.

The workspace is ``.workspace/mode7_check`` (every field is cached by its
metrics file, so a cut run carries on), the result
``nerf_prv_tpu_torch/experiments/results/mode7_check.json``; the log and a
copy of the result go to the gitignored ``runs.LOG_DIR``.  Objects run in
``--workers`` processes at once (the training is host-bound, so several
share the card); walls are taken under that sharing.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

from ..pipeline.compare import stat_budgets_from_labels, write_comparison_table
from .families import make_family_object
from .label_protocol import model_dir, pipeline_config, require_device
from .mode7_compare import (
    committed, committed_predictions, corpus_labels, install_eval_viewspace, run_mode7, score_budget, summarize,
)
from .runs import LOG_DIR, RESULTS_DIR, WORKSPACE, Log, build_kernels, card_line, run_jobs, write_json

LIMIT_OBJECTS = ("clu10", "uni11")
LIMIT_BUDGET = 28
LIMIT_SEEDS = (0, 1, 2)
PATH_RTOL = 1e-9
SEM_FACTOR = 2.0
PRV_BUDGETS = os.path.join(RESULTS_DIR, "prv_budgets.json")


def limit_job(job: tuple) -> dict:
    """One limit field (root, name, seed, device) in a worker process."""
    import torch

    root, name, seed, device = job
    torch.set_num_threads(1)
    return dict(name=name, seed=seed, **score_budget(pipeline_config(root), name, LIMIT_BUDGET, seed, device))


def compare_job(job: tuple) -> dict:
    """One object's mode 7 (root, name, predictions, device) in a worker
    process: its rows and each distinct budget's wall."""
    import torch

    root, name, predictions, device = job
    torch.set_num_threads(1)
    labels, val_labels, _ = corpus_labels()
    cfg = pipeline_config(root)
    walls = {}
    t0 = time.perf_counter()
    rows = run_mode7(cfg, [name], labels, stat_budgets_from_labels(val_labels), predictions=predictions,
                     device=device, walls=walls,
                     out_file=os.path.join(cfg.workspace, "tables", f"{name}.txt"))
    return dict(name=name, rows=rows, walls={str(b): w for (_, b), w in walls.items()},
                wall_s=time.perf_counter() - t0)


def seed_limit(values: dict) -> dict:
    """L_psnr and L_ssim: twice the larger of the objects' ranges over the
    seeds."""
    out = {}
    for k in ("PSNR", "SSIM"):
        ranges = {n: max(v[k] for v in per.values()) - min(v[k] for v in per.values()) for n, per in values.items()}
        out[f"L_{k.lower()}"] = 2.0 * max(ranges.values())
        out[f"ranges_{k.lower()}"] = ranges
    out["rule"] = f"2 x max over {', '.join(LIMIT_OBJECTS)} of (max - min over NeRF seeds 0, 1, 2) at budget 28"
    return out


def sign_test(diffs) -> dict:
    """Two-sided sign test of the differences' median against 0 (ties
    dropped): the counts and the exact binomial p-value."""
    pos = int(sum(d > 0 for d in diffs))
    neg = int(sum(d < 0 for d in diffs))
    n = pos + neg
    k = min(pos, neg)
    p = min(1.0, 2.0 * sum(math.comb(n, i) for i in range(k + 1)) / 2.0 ** n) if n else 1.0
    return dict(n_pos=pos, n_neg=neg, n_ties=len(diffs) - n, p_two_sided=p)


def pairs(rows: dict) -> dict:
    """{"name@budget": {PSNR, SSIM, path_len}} over the distinct (object,
    budget) pairs of mode-7 rows."""
    out = {}
    for name, entry in rows.items():
        for rec in entry.values():
            out.setdefault(f"{name}@{rec['budget']}", {k: rec[k] for k in ("PSNR", "SSIM", "path_len")})
    return out


def compare_deltas(port: dict, ref: dict) -> dict:
    """``summarize``'s deltas of the port beside the committed ones: the
    path deltas equal, each dPSNR mean within SEM_FACTOR x RSS of the SEMs."""
    out = {}
    for key, r in ref.items():
        p = port[key]
        bound = SEM_FACTOR * math.hypot(p["dPSNR_sem"], r["dPSNR_sem"])
        out[key] = dict(port=p, committed=r, dPSNR_bound=bound,
                        dPSNR_within=abs(p["dPSNR_mean"] - r["dPSNR_mean"]) <= bound,
                        dpath_equal=(p["dpath_mean"], p["dpath_sem"]) == (r["dpath_mean"], r["dpath_sem"]))
    return out


def _run_comparison(args, predictions: dict, log: Log, on_object) -> dict:
    labels, val_labels, test = corpus_labels()
    rows, walls = {}, {}
    jobs = [(args.root, n, predictions, str(args.device)) for n in test]
    for rec in run_jobs(compare_job, jobs, args.workers):
        rows.update(rec["rows"])
        walls[rec["name"]] = rec["walls"]
        e = rec["rows"].get(rec["name"], {})
        log(f"{rec['name']}: " + ", ".join(f"{k} {v['budget']} {v['PSNR']:.3f} dB" for k, v in e.items())
            + f" ({rec['wall_s']:.1f} s)")
        on_object(rows, walls)
    ordered = {n: rows[n] for n in test if n in rows}
    write_comparison_table(os.path.join(pipeline_config(args.root).workspace, "pvb_statistic_compare.txt"), ordered)
    return dict(rows=ordered, walls=walls, table=summarize(ordered, stat_budgets_from_labels(val_labels),
                                                           len(val_labels), len(test)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="workspace root (default .workspace/mode7_check[_live])")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--live", action="store_true", help="PRV budgets from results/prv_budgets.json")
    ap.add_argument("--out", default=None)
    ap.add_argument("--log", default=None)
    args = ap.parse_args(argv)
    tag = "mode7_live" if args.live else "mode7_check"
    args.root = args.root or os.path.join(WORKSPACE, tag)
    args.out = args.out or (PRV_BUDGETS if args.live else os.path.join(RESULTS_DIR, "mode7_check.json"))
    log = Log(args.log or os.path.join(LOG_DIR, f"{tag}.log"))
    args.device = require_device(args.device)
    card = card_line()
    log(f"{tag} on {card}; workspace {args.root}, {args.workers} workers")
    build_kernels(args.device)
    cfg = pipeline_config(args.root)
    install_eval_viewspace(cfg)
    for name in corpus_labels()[2]:
        make_family_object(name, model_dir(cfg))
    from ..scene.object_setup import _ensure_viewspace

    _ensure_viewspace(cfg.viewspace_path, cfg.num_of_views, args.device)  # once, not in every worker
    ref = committed()
    t0 = time.perf_counter()

    if args.live:
        with open(args.out) as f:
            result = json.load(f)
        predictions = result["budgets"]

        def flush(rows, walls):
            result["mode7"] = dict(card=card, rows=rows, walls=walls)
            write_json(args.out, result, LOG_DIR)

        out = _run_comparison(args, predictions, log, flush)
        table = out["table"]
        result["mode7"] = dict(card=card, summary=table["summary"], deltas=table["deltas"],
                               stat_budgets=table["stat_budgets"], committed_summary=ref["summary"],
                               committed_deltas=ref["deltas"], rows=out["rows"], walls=out["walls"],
                               wall_s_total=time.perf_counter() - t0)
        write_json(args.out, result, LOG_DIR)
        log(f"live mode 7 ({card}): deltas {json.dumps(table['deltas'])}; committed {json.dumps(ref['deltas'])}")
        return 0

    result = dict(card=card, protocol=dict(camera="320x180 model 0", n_steps=cfg.n_steps, workers=args.workers,
                                           predictions="committed prv budgets"), limit_runs={})
    jobs = [(args.root, n, s, str(args.device)) for n in LIMIT_OBJECTS for s in LIMIT_SEEDS]
    for rec in run_jobs(limit_job, jobs, args.workers):
        result["limit_runs"][f"{rec['name']}@{rec['seed']}"] = rec
        write_json(args.out, result, LOG_DIR)
        log(f"limit field {rec['name']}@28 seed {rec['seed']}: PSNR {rec['PSNR']:.4f} SSIM {rec['SSIM']:.4f} "
            f"({rec['wall_s']:.1f} s)")
    values = {n: {s: result["limit_runs"][f"{n}@{s}"] for s in LIMIT_SEEDS} for n in LIMIT_OBJECTS}
    result["limit"] = dict(psnr={n: [v[s]["PSNR"] for s in LIMIT_SEEDS] for n, v in values.items()},
                           ssim={n: [v[s]["SSIM"] for s in LIMIT_SEEDS] for n, v in values.items()},
                           **seed_limit(values))
    write_json(args.out, result, LOG_DIR)
    L_psnr, L_ssim = result["limit"]["L_psnr"], result["limit"]["L_ssim"]
    log(f"LIMIT written before the comparison: L_psnr = {L_psnr:.4f} dB, L_ssim = {L_ssim:.5f} "
        f"(PSNRs {json.dumps(result['limit']['psnr'])})")

    def flush(rows, walls):
        result["rows"], result["walls"] = rows, walls
        write_json(args.out, result, LOG_DIR)

    out = _run_comparison(args, committed_predictions(), log, flush)
    result["rows"], result["walls"] = out["rows"], out["walls"]
    port_pairs, ref_pairs = pairs(out["rows"]), pairs(ref["rows"])
    cmp = {}
    for key, want in ref_pairs.items():
        got = port_pairs.get(key)
        if got is None:
            continue
        name, budget = key.split("@")
        cmp[key] = dict(
            port=got, committed=want, wall_s=out["walls"].get(name, {}).get(budget),
            dPSNR=got["PSNR"] - want["PSNR"], dSSIM=got["SSIM"] - want["SSIM"],
            path_rel_err=abs(got["path_len"] - want["path_len"]) / want["path_len"],
        )
        cmp[key]["psnr_within_L"] = abs(cmp[key]["dPSNR"]) <= L_psnr
        cmp[key]["ssim_within_L"] = abs(cmp[key]["dSSIM"]) <= L_ssim
        cmp[key]["path_equal"] = cmp[key]["path_rel_err"] <= PATH_RTOL
    result["comparison"] = cmp
    d = [c["dPSNR"] for c in cmp.values()]
    result["deltas"] = compare_deltas(out["table"]["deltas"], ref["deltas"])
    result["table"] = {k: out["table"][k] for k in ("summary", "deltas", "stat_budgets", "val_n", "n_done")}
    result["summary"] = dict(
        n_objects=len(out["rows"]), n_pairs=len(cmp), n_pairs_committed=len(ref_pairs),
        stat_budgets_equal=out["table"]["stat_budgets"] == ref["stat_budgets"],
        paths_equal=all(c["path_equal"] for c in cmp.values()),
        path_rel_err_max=max(c["path_rel_err"] for c in cmp.values()),
        psnr_share_within_L=float(np.mean([c["psnr_within_L"] for c in cmp.values()])),
        ssim_share_within_L=float(np.mean([c["ssim_within_L"] for c in cmp.values()])),
        dPSNR_mean=float(np.mean(d)), dPSNR_sem=float(np.std(d, ddof=1) / np.sqrt(len(d))),
        dSSIM_mean=float(np.mean([c["dSSIM"] for c in cmp.values()])),
        sign_test=sign_test(d),
        dpath_equal=all(v["dpath_equal"] for v in result["deltas"].values()),
        dPSNR_within=all(v["dPSNR_within"] for v in result["deltas"].values()),
        wall_s_total=time.perf_counter() - log.t0,
    )
    write_json(args.out, result, LOG_DIR)
    for key, c in cmp.items():
        log(f"{key}: PSNR {c['port']['PSNR']:.3f} / {c['committed']['PSNR']:.3f} ({c['dPSNR']:+.3f}, within L "
            f"{c['psnr_within_L']}), SSIM {c['dSSIM']:+.4f}, path rel err {c['path_rel_err']:.2e}, "
            f"{c['wall_s'] if c['wall_s'] is not None else float('nan'):.1f} s")
    for key, v in result["deltas"].items():
        log(f"{key}: port {v['port']} committed {v['committed']} (dPSNR within {v['dPSNR_bound']:.4f}: "
            f"{v['dPSNR_within']}, dpath equal: {v['dpath_equal']})")
    log(f"summary ({card}): {json.dumps(result['summary'])}")
    s = result["summary"]
    return 0 if s["paths_equal"] and s["dpath_equal"] and s["dPSNR_within"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
