"""The pilot-2 check: the tail anchors ``nos0``, ``nos7``, ``fan0`` and
``fan7`` through the port's label protocol at NeRF seeds 0, 1 and 2, against
the JAX package's committed ``label_spread_pilot2.json`` (36 / 57 / 34 / 25,
all converged).

    python -m nerf_prv_tpu_torch.experiments.check_pilot2 [--workers 6]

In this order, on the card:
1. Limit.  L = 8 views, the label check's limit (``results/labels_check.json``,
   written there before any of that check's comparisons), goes to the result
   file and the log before any run.
2. The 12 protocol runs (``label_protocol.protocol_job``: 4 objects x NeRF
   seeds 0-2, the seeds other than 0 in workspaces of their own,
   ``seed_workspace``), in ``--workers`` processes that share the card.
3. Record: each label against the committed one and whether it lies within
   L, every ``converged`` flag, each object's range over the seeds, and
   nos7's three labels against the committed 57 and the port's earlier 63
   (``labels_check.json``, seed 0).  A miss fails nothing: it is recorded
   with its numbers.  The seed-0 runs also give the script's own artifact
   (``label_spread2.pilot2_artifact``; walls under the sharing).

The workspace is ``.workspace/pilot2_check`` (a cut run carries on), the
result ``nerf_prv_tpu_torch/experiments/results/label_spread_pilot2_check.json``;
the log and a copy of the result go to the gitignored ``runs.LOG_DIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from .corpus_dataset import ARTIFACTS
from .families import make_family_object
from .label_protocol import (
    fit_counts, install_reference_viewspace, model_dir, pipeline_config, protocol_job, require_device,
)
from .label_spread2 import PILOT2, pilot2_artifact
from .runs import LOG_DIR, RESULTS_DIR, WORKSPACE, Log, build_kernels, card_line, run_jobs, write_json

SEEDS = (0, 1, 2)
LABELS_CHECK = os.path.join(RESULTS_DIR, "labels_check.json")


def committed_pilot2(art: str = ARTIFACTS) -> dict:
    """The JAX package's pilot-2 artifact."""
    with open(os.path.join(art, "label_spread_pilot2.json")) as f:
        return json.load(f)


def label_limit(path: str = LABELS_CHECK) -> dict:
    """The label check's limit L and the port's earlier seed-0 labels of the
    pilot's objects, from the label check's result."""
    with open(path) as f:
        rec = json.load(f)
    earlier = {k.split("@")[0]: r["label"] for k, r in rec["runs"].items() if k.endswith("@0")
               and k.split("@")[0] in PILOT2}
    return dict(L=rec["limit"]["L"], rule=rec["limit"]["rule"], source="results/labels_check.json",
                port_seed0_labels=earlier)


def summarize(runs: dict, ref: dict, limit: dict) -> dict:
    """Per object: each seed's label and flag beside the committed ones, the
    difference and whether it lies within L, and the range over the seeds."""
    L, rows = limit["L"], {}
    for name in PILOT2:
        want = ref["objects"][name]
        got = {s: runs[f"{name}@{s}"] for s in SEEDS if f"{name}@{s}" in runs}
        labels = {s: r["label"] for s, r in got.items()}
        rows[name] = dict(
            committed=want["label"], committed_converged=want["converged"], labels=labels,
            converged={s: r["converged"] for s, r in got.items()},
            diff={s: v - want["label"] for s, v in labels.items()},
            within_L={s: abs(v - want["label"]) <= L for s, v in labels.items()},
            seed_range=(max(labels.values()) - min(labels.values())) if labels else None,
            mean=(sum(labels.values()) / len(labels)) if labels else None,
        )
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(WORKSPACE, "pilot2_check"))
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "label_spread_pilot2_check.json"))
    ap.add_argument("--log", default=os.path.join(LOG_DIR, "pilot2_check.log"))
    args = ap.parse_args(argv)
    device = require_device(args.device)
    log = Log(args.log)
    card = card_line()
    ref = committed_pilot2()
    limit = label_limit()
    cfg = pipeline_config(args.root)
    result = dict(card=card, limit=limit,
                  protocol=dict(camera="320x180 model 0", n_steps=cfg.n_steps, counts=fit_counts(cfg),
                                label="gradient@0.02", workers=args.workers, seeds=list(SEEDS)),
                  committed=ref["objects"], runs={})
    if os.path.exists(args.out):
        with open(args.out) as f:
            result["runs"] = json.load(f).get("runs", {})
    write_json(args.out, result, LOG_DIR)
    log(f"pilot-2 check on {card}; LIMIT written before any run: L = {limit['L']} views ({limit['rule']}, "
        f"{limit['source']}); workspace {args.root}, {args.workers} workers")
    build_kernels(device)

    # what every worker reads, prepared once: the PLYs and the view spaces
    install_reference_viewspace(cfg, fit_counts(cfg) + [64, 100], probe=True)
    for name in PILOT2:
        make_family_object(name, model_dir(cfg))
    from ..pipeline import modes
    from ..scene.object_setup import _ensure_viewspace

    modes.mode_view_cover(cfg, sizes=fit_counts(cfg) + [64, 100], device=device)
    _ensure_viewspace(cfg.viewspace_path, cfg.num_of_views, device)

    t0 = time.perf_counter()
    # nos7 first: it took the longest on the reference's run
    order = ("nos7",) + tuple(n for n in PILOT2 if n != "nos7")
    jobs = [(args.root, n, s, str(device)) for s in SEEDS for n in order if f"{n}@{s}" not in result["runs"]]
    for rec in run_jobs(protocol_job, jobs, args.workers):
        result["runs"][f"{rec['name']}@{rec['seed']}"] = rec
        write_json(args.out, result, LOG_DIR)
        want = ref["objects"][rec["name"]]
        log(f"{rec['name']} seed {rec['seed']}: label {rec['label']} (committed {want['label']}, "
            f"{rec['label'] - want['label']:+d}) converged {rec['converged']} (committed {want['converged']}), "
            f"{rec['wall_s']:.1f} s")
    rows = summarize(result["runs"], ref, limit)
    seed0 = {n: result["runs"][f"{n}@0"] for n in PILOT2 if f"{n}@0" in result["runs"]}
    result["artifact_seed0"] = pilot2_artifact({n: (r["label"], r["converged"]) for n, r in seed0.items()},
                                               {n: r["wall_s"] for n, r in seed0.items()},
                                               time.perf_counter() - t0)
    nos7 = rows["nos7"]
    result["comparison"] = rows
    result["nos7"] = dict(labels=nos7["labels"], mean=nos7["mean"], committed=nos7["committed"],
                          port_earlier=limit["port_seed0_labels"].get("nos7"),
                          diff_to_committed=nos7["diff"],
                          diff_to_port_earlier={s: v - limit["port_seed0_labels"].get("nos7", v)
                                                for s, v in nos7["labels"].items()})
    result["summary"] = dict(
        n_runs=sum(len(r["labels"]) for r in rows.values()),
        n_within_L=sum(sum(r["within_L"].values()) for r in rows.values()),
        converged_equal=sum(v == r["committed_converged"] for r in rows.values() for v in r["converged"].values()),
        seed_ranges={n: r["seed_range"] for n, r in rows.items()},
        misses=sorted(f"{n}@{s}" for n, r in rows.items() for s in r["labels"]
                      if not r["within_L"][s] or r["converged"][s] != r["committed_converged"]),
        wall_s_total=time.perf_counter() - log.t0,
    )
    write_json(args.out, result, LOG_DIR)
    for n, r in rows.items():
        log(f"{n}: labels {r['labels']} (committed {r['committed']}, diffs {r['diff']}, within L={limit['L']}: "
            f"{r['within_L']}), converged {r['converged']} (committed {r['committed_converged']}), "
            f"range {r['seed_range']}")
    log(f"nos7: {json.dumps(result['nos7'])}")
    log(f"summary ({card}): {json.dumps(result['summary'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
