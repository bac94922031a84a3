"""The label check: the port's label protocol on the PRV corpus against the
JAX package's committed labels.

    python -m nerf_prv_tpu_torch.experiments.check_labels [--workers 6]

In this order, on the card:
1. Limit.  ``cup0`` and ``pla0`` (committed 35 and 30) run at NeRF seeds 0,
   1 and 2.  The limit L is the larger of the two objects' label ranges plus
   one view for the integer rounding; L and the six labels go to the result
   file and the log before any comparison is made.
2. Comparison.  The twelve index-0 objects, one per family, all converged
   in ``dataset100_labels.json``, and ``spi7`` (21) and ``nos7`` (57) from
   the pilots, each at seed 0 (``cup0`` and ``pla0`` reused): the port's
   label, the committed label, both converged flags, the per-count PSNRs,
   the fitted gain at the label beside 0.02, and the wall.
3. Summary.  The Spearman rank correlation of the 14 labels, how many lie
   within L, whether every converged flag is equal.

The workspace is ``.workspace/labels_check`` (each stage skips what its
files say is done, so a cut run carries on), the result
``nerf_prv_tpu_torch/experiments/results/labels_check.json``; the log and a
copy of the result go to the gitignored ``runs.LOG_DIR``, which a run on a
remote card brings back.  Objects run in ``--workers`` processes at once: the
NeRF training is host-bound, so several share the card.  Walls are taken
under that sharing.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np

from .corpus_dataset import ARTIFACTS
from .families import FAMILIES, make_family_object
from .label_protocol import (
    fit_counts, install_reference_viewspace, model_dir, pipeline_config, protocol_job, require_device,
)
from .runs import LOG_DIR, RESULTS_DIR, WORKSPACE, Log, build_kernels, card_line, run_jobs, write_json

SPREAD_OBJECTS = ("cup0", "pla0")
SPREAD_SEEDS = (0, 1, 2)
ROUNDING = 1  # a view, for the integer label
COMPARE_OBJECTS = tuple(f"{fam}0" for fam in FAMILIES) + ("spi7", "nos7")


def committed_labels(art: str = ARTIFACTS) -> Dict[str, dict]:
    """name -> {label, converged} of the JAX package's committed runs: the
    round-3 corpus and the two pilots (which agree where they overlap)."""
    out = {}
    for name in ("label_spread_pilot.json", "label_spread_pilot2.json", "dataset100_labels.json"):
        with open(os.path.join(art, name)) as f:
            out.update(json.load(f)["objects"])
    return out


def _ranks(x) -> np.ndarray:
    """Ranks from 1, ties given their mean rank."""
    x = np.asarray(x, np.float64)
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x))
    ranks[order] = np.arange(1, len(x) + 1)
    for v in np.unique(x):
        tie = x == v
        ranks[tie] = ranks[tie].mean()
    return ranks


def spearman(a, b) -> float:
    """Spearman's rank correlation (Pearson's over tie-averaged ranks)."""
    return float(np.corrcoef(_ranks(a), _ranks(b))[0, 1])


def spread_limit(labels: Dict[str, Dict[int, int]]) -> dict:
    """L = the larger of the objects' label ranges over the seeds, plus the
    rounding view."""
    ranges = {n: max(v.values()) - min(v.values()) for n, v in labels.items()}
    return dict(L=max(ranges.values()) + ROUNDING, ranges=ranges,
                rule="max over cup0, pla0 of (max - min label over NeRF seeds 0, 1, 2) + 1 view")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(WORKSPACE, "labels_check"))
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "labels_check.json"))
    ap.add_argument("--log", default=os.path.join(LOG_DIR, "labels_check.log"))
    args = ap.parse_args(argv)
    device = require_device(args.device)
    log = Log(args.log)
    card = card_line()
    log(f"label check on {card}; workspace {args.root}, {args.workers} workers")
    build_kernels(device)

    # what every worker reads, prepared once: the PLYs and the view spaces
    cfg = pipeline_config(args.root)
    install_reference_viewspace(cfg, fit_counts(cfg) + [64, 100], probe=True)
    names = sorted(set(SPREAD_OBJECTS) | set(COMPARE_OBJECTS))
    for name in names:
        make_family_object(name, model_dir(cfg))
    from ..pipeline import modes
    from ..scene.object_setup import _ensure_viewspace

    modes.mode_view_cover(cfg, sizes=fit_counts(cfg) + [64, 100], device=device)
    _ensure_viewspace(cfg.viewspace_path, cfg.num_of_views, device)

    committed = committed_labels()
    result = dict(card=card, protocol=dict(camera="320x180 model 0", n_steps=cfg.n_steps, counts=fit_counts(cfg),
                                           label="gradient@0.02", workers=args.workers), runs={})

    def record(rec):
        result["runs"][f"{rec['name']}@{rec['seed']}"] = rec
        write_json(args.out, result, LOG_DIR)
        log(f"{rec['name']} seed {rec['seed']}: label {rec['label']} converged {rec['converged']} "
            f"(gain {rec.get('gain_before_label', float('nan')):.4f} -> {rec.get('gain_at_label', float('nan')):.4f} "
            f"dB/view across 0.02), {rec['wall_s']:.1f} s")

    jobs = [(args.root, n, s, str(device)) for n in SPREAD_OBJECTS for s in SPREAD_SEEDS]
    for rec in run_jobs(protocol_job, jobs, args.workers):
        record(rec)
    spread = {n: {s: result["runs"][f"{n}@{s}"]["label"] for s in SPREAD_SEEDS} for n in SPREAD_OBJECTS}
    result["limit"] = dict(labels=spread, **spread_limit(spread))
    write_json(args.out, result, LOG_DIR)
    log(f"LIMIT written before the comparison: L = {result['limit']['L']} views "
        f"(ranges {result['limit']['ranges']}; labels {spread})")

    # the pilots' two objects first: nos7 took the longest on the reference's run
    todo = [n for n in COMPARE_OBJECTS[-2:] + COMPARE_OBJECTS[:-2] if f"{n}@0" not in result["runs"]]
    jobs = [(args.root, n, 0, str(device)) for n in todo]
    for rec in run_jobs(protocol_job, jobs, args.workers):
        record(rec)
    L = result["limit"]["L"]
    rows = {}
    for n in COMPARE_OBJECTS:
        rec, ref = result["runs"][f"{n}@0"], committed[n]
        rows[n] = dict(port=rec["label"], committed=ref["label"], diff=rec["label"] - ref["label"],
                       within_L=abs(rec["label"] - ref["label"]) <= L, port_converged=rec["converged"],
                       committed_converged=ref["converged"], wall_s=rec["wall_s"])
    result["comparison"] = rows
    result["summary"] = dict(
        spearman=spearman([r["port"] for r in rows.values()], [r["committed"] for r in rows.values()]),
        n_objects=len(rows), n_within_L=sum(r["within_L"] for r in rows.values()),
        converged_equal=all(r["port_converged"] == r["committed_converged"] for r in rows.values()),
        misses=[n for n, r in rows.items() if not r["within_L"] or r["port_converged"] != r["committed_converged"]],
        wall_s_total=time.perf_counter() - log.t0,
    )
    write_json(args.out, result, LOG_DIR)
    for n, r in rows.items():
        log(f"{n}: port {r['port']} committed {r['committed']} (diff {r['diff']:+d}, within L={L}: "
            f"{r['within_L']}), converged {r['port_converged']}/{r['committed_converged']}, {r['wall_s']:.1f} s")
    log(f"summary ({card}): {json.dumps(result['summary'])}")
    return 0 if not result["summary"]["misses"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
