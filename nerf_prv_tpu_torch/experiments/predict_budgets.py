"""The port's own PRV budgets for the held-out roster: the tiny@180 predictor
trained by the port, gated, and asked for each test object's budget.

    python -m nerf_prv_tpu_torch.experiments.predict_budgets [--workers 6] [--seed 0] [--skip-gate]

On the card:
1. The committed corpus's ``pvb_dataset`` (117 objects, 90 train / 27 val,
   as the predictor check builds it) and the tiny@180 recipe at
   ``TrainConfig.seed`` ``--seed`` through ``prvnet_recipe.run_two_stage``.
2. ``predictor_gate`` on the recipe's own val metrics (correlation >= 0.3,
   predictions spanning >= 5 views): a degenerate predictor writes no
   budgets (``--skip-gate`` lets it through, for debugging, and the attempt
   records the gate as skipped).  Every attempt (its val metrics, val L1 by
   epoch and the gate's decision) is kept under ``attempts``: the training
   is not bit-reproducible on the card (cuDNN's nondeterministic kernels),
   so a run that is refused may be repeated.
3. Each of the 10 test objects loaded and its 5-view qcam set rendered;
   its budget predicted from views [0, 1, 3], as ``compare_objects`` asks
   the predictor (``pipeline/compare.py``).  ``predict_test_budgets`` also
   serves the tiny@720 predictor (``check_hd``), which reads the hd set.

The budgets, the val metrics, the committed tiny@720 budgets beside them and
the card go to ``nerf_prv_tpu_torch/experiments/results/prv_budgets.json``;
``check_mode7 --live`` and ``check_mode21 --live`` then run at these budgets
and add their tables to the same file.  The workspace is
``.workspace/prv_budgets``; the log goes to the gitignored ``runs.LOG_DIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from .corpus_dataset import prepare_dataset, render_hd_sets
from .families import make_family_object
from .label_protocol import model_dir, pipeline_config, require_device
from .mode7_compare import HDPredictor, committed_predictions, corpus_labels, live_predictor
from .predictor_gate import predictor_gate
from .prvnet_recipe import ARCH, CROP, run_two_stage
from .runs import LOG_DIR, RESULTS_DIR, WORKSPACE, Log, build_kernels, card_line, write_json

INIT_VIEWS = (0, 1, 3)  # the 5-view set's pattern the predictor reads (≙ infer_server.py:47)
VAL_KEYS = ("val_pred_gt_corr", "val_pred_min_max", "val_pred_std", "val_gt_std", "best_val_l1_mean",
            "best_val_accuracy", "pretrain_seconds", "train_seconds", "n_train", "n_val")


def predict_test_budgets(cfg, names, checkpoint: str, device, arch: str = ARCH, crop: int = CROP) -> dict:
    """name -> the predictor's budget from views ``INIT_VIEWS`` of the
    object's 5-view set (rendered where missing).  A predictor of crop 720
    or more reads the hd 5-view set instead (``live_predictor``), rendered
    here where missing."""
    from ..pipeline.coverage import get_coverage
    from ..scene.object_setup import load_object

    predictor = live_predictor(checkpoint, arch, crop, device=device)
    out = {}
    for name in names:
        make_family_object(name, model_dir(cfg))
        obj_cfg = cfg.replace(name_of_pcd=name)
        scene = load_object(obj_cfg, name, device=device)
        if not scene.ok:
            raise RuntimeError(f"{name}: the object did not load")
        get_coverage(scene, obj_cfg, 5, device=device)
        if isinstance(predictor, HDPredictor):
            render_hd_sets(scene, obj_cfg, hd_train=False, device=device)
        out[name] = int(predictor.predict_from_coverage(os.path.join(obj_cfg.gt_path, "5"), list(INIT_VIEWS)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(WORKSPACE, "prv_budgets"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pretrain-epochs", type=int, default=None, help="cut the recipe (a rehearsal)")
    ap.add_argument("--epochs", type=int, default=None, help="cut the recipe (a rehearsal)")
    ap.add_argument("--skip-gate", action="store_true", help="write budgets from a refused predictor (debugging)")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "prv_budgets.json"))
    ap.add_argument("--log", default=os.path.join(LOG_DIR, "prv_budgets.log"))
    args = ap.parse_args(argv)
    device = require_device(args.device)
    log = Log(args.log)
    card = card_line()
    log(f"PRV budgets on {card}; recipe tiny@180 seed {args.seed}, workspace {args.root}")
    build_kernels(device)
    t0 = time.perf_counter()
    ds = prepare_dataset(args.root, args.workers, device)
    log(f"dataset: {ds['n_loaded']} of {ds['n_names']} objects loaded, {len(ds['train'])} train / "
        f"{len(ds['val'])} val ({time.perf_counter() - t0:.1f} s)")
    cut = {k: v for k, v in (("pretrain_epochs", args.pretrain_epochs), ("epochs", args.epochs)) if v is not None}
    out_dir = os.path.join(args.root, f"tiny180_seed{args.seed}")
    art = run_two_stage(ds["root"], out_dir, seed=args.seed, device=device, **cut)
    result = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            result = {k: v for k, v in json.load(f).items() if k == "attempts"}
    attempt = dict(card=card, recipe=dict(arch=ARCH, crop=CROP, seed=args.seed, **cut),
                   val={k: art[k] for k in VAL_KEYS if k in art}, val_l1_by_epoch=art.get("val_l1_by_epoch"))
    result.setdefault("attempts", []).append(attempt)
    try:
        predictor_gate(os.path.join(out_dir, "result.json"), skip=args.skip_gate)
    except SystemExit as refused:
        attempt["gate"] = dict(passed=False, reason=str(refused))
        write_json(args.out, result, LOG_DIR)
        raise
    attempt["gate"] = dict(skipped=True) if args.skip_gate else dict(passed=True)
    log(f"gate {'skipped' if args.skip_gate else 'passed'}: val corr {art['val_pred_gt_corr']:.4f}, "
        f"predictions {art['val_pred_min_max']}")
    t1 = time.perf_counter()
    _, _, test = corpus_labels()
    budgets = predict_test_budgets(pipeline_config(args.root), test,
                                   os.path.join(out_dir, "regression", "best_checkpoint.msgpack"), device)
    result.update(card=card, recipe=attempt["recipe"], val=attempt["val"], val_per_object=art.get("val_per_object"),
                  budgets=budgets, committed_tiny720_budgets=committed_predictions(),
                  predict_wall_s=time.perf_counter() - t1, wall_s_total=time.perf_counter() - t0)
    write_json(args.out, result, LOG_DIR)
    log(f"budgets ({card}): {json.dumps(budgets)}; committed tiny@720 {json.dumps(committed_predictions())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
