"""The predictor check: the tiny@180 PRVNet recipe trained by the port on
the PRV corpus, against the JAX package's committed ``prvnet_tiny180.json``
(best val L1 2.988, val correlation 0.7425) and its 800-epoch log.

    python -m nerf_prv_tpu_torch.experiments.check_prvnet [--seeds 0 1 2]

On the card:
1. The 117 dataset objects' PLYs (families) and 64-view sets at the 320x180
   camera (one K8 launch a set), rendered in ``--workers`` processes, and
   ``pvb_dataset`` assembled from the committed labels and split: 90 train
   / 27 val, or the run stops.
2. The two-stage recipe at ``TrainConfig.seed`` 0, 1 and 2, each seed's
   result kept in the result file as it finishes (``--seeds`` runs some of
   them; a later run adds the rest, reading the file back).
3. Once three seeds are in: the limits from the port's own spread, written
   to the result file and the log first; then the committed best val L1 and
   correlation held to them.  A limit is the three seeds' range widened by
   that range on each side: [min - r, max + r], r = max - min.  The val L1
   at epochs 50, 100, 200, 400 and 800 stands beside the committed log's.

The workspace is ``.workspace/prvnet_check``, the result
``nerf_prv_tpu_torch/experiments/results/prvnet_tiny180_check.json``; the log
and a copy of the result go to the gitignored ``runs.LOG_DIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .corpus_dataset import ARTIFACTS, prepare_dataset
from .label_protocol import require_device
from .prvnet_recipe import EPOCHS, PRETRAIN_EPOCHS, run_two_stage
from .runs import LOG_DIR, RESULTS_DIR, WORKSPACE, Log, build_kernels, card_line, write_json

SEEDS = (0, 1, 2)
EPOCH_MARKS = (50, 100, 200, 400, 800)
N_TRAIN, N_VAL = 90, 27
METRICS = ("best_val_l1_mean", "val_pred_gt_corr")


def committed(art: str = ARTIFACTS) -> dict:
    """The JAX package's tiny@180 record and its val L1 by epoch."""
    with open(os.path.join(art, "prvnet_tiny180.json")) as f:
        rec = json.load(f)
    with open(os.path.join(art, "prvnet_tiny180_ckpt", "log.jsonl")) as f:
        rec["val_l1_by_epoch"] = [json.loads(line)["l1_mean"] for line in f]
    return rec


def seed_limits(seeds: dict) -> dict:
    """Each metric's interval from the seeds' spread: [min - r, max + r]."""
    out = {}
    for key in METRICS:
        v = [s[key] for s in seeds.values()]
        r = max(v) - min(v)
        out[key] = dict(values=v, range=r, low=min(v) - r, high=max(v) + r)
    out["rule"] = "each metric's three-seed interval widened by its range on both sides"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(WORKSPACE, "prvnet_check"))
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pretrain-epochs", type=int, default=PRETRAIN_EPOCHS)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "prvnet_tiny180_check.json"))
    ap.add_argument("--log", default=os.path.join(LOG_DIR, "prvnet_check.log"))
    args = ap.parse_args(argv)
    device = require_device(args.device)
    log = Log(args.log)
    card = card_line()
    recipe = dict(pretrain_epochs=args.pretrain_epochs, epochs=args.epochs)
    log(f"predictor check on {card}; seeds {args.seeds}, recipe {recipe}")
    result = dict(card=card, cards=[card], recipe=recipe, seeds={})
    if os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        if prev.get("recipe") == recipe:
            result["seeds"] = prev.get("seeds", {})
            result["cards"] = sorted(set(prev.get("cards", [prev.get("card")])) | {card})
    build_kernels(device)

    t0 = time.perf_counter()
    ds = prepare_dataset(args.root, args.workers, device)
    result["dataset"] = dict(n_objects=len(ds["labels"]), n_loaded=ds["n_loaded"], n_train=len(ds["train"]),
                             n_val=len(ds["val"]), n_test=len(ds["test"]), wall_s=time.perf_counter() - t0)
    log(f"dataset: {json.dumps(result['dataset'])}")
    if (len(ds["train"]), len(ds["val"]), ds["n_loaded"]) != (N_TRAIN, N_VAL, ds["n_names"]):
        write_json(args.out, result, LOG_DIR)
        raise SystemExit(f"the dataset is not the committed one: {result['dataset']}")

    for seed in args.seeds:
        if str(seed) in result["seeds"]:
            continue
        art = run_two_stage(ds["root"], os.path.join(args.root, f"tiny180_seed{seed}"), seed=seed,
                            pretrain_epochs=args.pretrain_epochs, epochs=args.epochs, device=device)
        result["seeds"][str(seed)] = art
        write_json(args.out, result, LOG_DIR)
        log(f"seed {seed}: best val L1 {art['best_val_l1_mean']:.4f}, corr {art['val_pred_gt_corr']:.4f}, "
            f"pretrain {art['pretrain_seconds']:.1f} s (best L1 {art['pretrain_best_l1']:.4f}), "
            f"regression {art['train_seconds']:.1f} s")

    ref = committed()
    marks = [e for e in EPOCH_MARKS if e <= args.epochs]
    result["val_l1_at_epoch"] = {
        "committed": {e: ref["val_l1_by_epoch"][e - 1] for e in marks},
        **{f"seed {s}": {e: a["val_l1_by_epoch"][e - 1] for e in marks} for s, a in result["seeds"].items()},
    }
    log(f"val L1 at epochs {marks}: {json.dumps(result['val_l1_at_epoch'])}")
    if len(result["seeds"]) < len(SEEDS):
        write_json(args.out, result, LOG_DIR)
        log(f"{len(result['seeds'])} of {len(SEEDS)} seeds in; the limits wait for the rest")
        return 0
    result["limits"] = seed_limits(result["seeds"])
    write_json(args.out, result, LOG_DIR)
    log(f"LIMITS written before the comparison: {json.dumps(result['limits'])}")
    want = {"best_val_l1_mean": ref["best_val_l1_mean"], "val_pred_gt_corr": ref["val_pred_gt_corr"]}
    result["comparison"] = {
        k: dict(committed=v, port_mean=float(np.mean(result["limits"][k]["values"])),
                within=result["limits"][k]["low"] <= v <= result["limits"][k]["high"])
        for k, v in want.items()
    }
    write_json(args.out, result, LOG_DIR)
    log(f"comparison ({card}): {json.dumps(result['comparison'])}")
    return 0 if all(c["within"] for c in result["comparison"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
