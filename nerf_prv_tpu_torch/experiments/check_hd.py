"""The hd arm's card check: the 1280x720 PVB sets, the tiny@720 step
measurement, the tiny@720 recipe, its gate and its live budgets, and (if
the gate passes) mode 7's PRV arm and mode 21's method 4 through
``HDPredictor``.

    python -m nerf_prv_tpu_torch.experiments.check_hd [--stages a b c d e f] [--workers 6]
        [--pretrain-epochs P] [--epochs E]

Stages, in order (``--stages`` picks some; each is skipped once its result
is in the result file, which a later call reads back):
(a) ``prepare_dataset(hd=True)``: every corpus object's PLY and 64-view set
    at 320x180, its hd 5-view set at 1280x720 (the 10 test objects' too)
    and, for the 117 train and val objects, the ``HD_VIEWS``-view hd set;
    then ``pvb_dataset`` and ``pvb_dataset_hd`` with the linked and dropped
    objects.  It runs again in a call whose later stages need the files.
(b) ``tiny720.run``: one tiny@720 step, batch 64 halved until it fits;
    ``results/tiny720.json``.
(probe) the tiny@720 recipe at 1 + 1 epochs: each stage's seconds, from
    which the cut of (c) is chosen (only when named in ``--stages``).
(c) the tiny@720 recipe (``prvnet_recipe.RECIPES["tiny720"]``) at
    ``--seed`` on ``pvb_dataset_hd``, at ``--pretrain-epochs`` + ``--epochs``
    (the recipe's 100 + 800 unless cut), beside the committed
    ``prvnet_tiny720.json`` and its logs (at the cut's epochs too), with the
    full protocol's wall projected from the measured epochs.
(d) ``predictor_gate`` on (c)'s artifact, its verdict recorded.
(e) the live ``HDPredictor`` budgets of the 10 test objects from (c)'s
    checkpoint (``predict_test_budgets`` at crop 720), beside the committed
    tiny@720 budgets (``mode7_r4.json``'s PRV rows).
(f) only if (d) passed, as the reference's scripts refuse a degenerate
    predictor: mode 7's PRV arm on the 10 test objects (each object's field
    at (e)'s budget, scored as ``compare_objects`` scores it) and mode 21's
    method 4 on ``pick_objects``' five through ``live_predictor``, beside
    the committed rows.

The workspace is ``.workspace/hd_check``, the result
``nerf_prv_tpu_torch/experiments/results/hd_check.json``; the log and a copy
of the result go to the gitignored ``runs.LOG_DIR``.  The checkpoints stay
in the workspace: (e) and (f) run in the call that trains (c).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from . import tiny720
from .check_prvnet import committed as committed_recipe
from .check_prvnet import prediction_table
from .corpus_dataset import ARTIFACTS, HD_INIT_VIEWS, HD_VIEWS, corpus_roster, prepare_dataset
from .families import make_family_object
from .label_protocol import model_dir, pipeline_config, require_device
from .mode7_compare import committed as committed_mode7
from .mode7_compare import committed_predictions, install_eval_viewspace, live_predictor, score_budget
from .mode21_table import committed as committed_mode21
from .mode21_table import mode21_config, pick_objects, run_rows
from .predict_budgets import predict_test_budgets
from .predictor_gate import predictor_gate
from .prvnet_recipe import ARCH, HD_CROP, RECIPES, run_two_stage
from .runs import LOG_DIR, RESULTS_DIR, WORKSPACE, Log, build_kernels, card_line, run_jobs, write_json

RECIPE = "tiny720"
STAGES = ("a", "b", "probe", "c", "d", "e", "f")
DEFAULT_STAGES = ("a", "b", "c", "d", "e", "f")
N_TRAIN, N_VAL, N_TEST = 90, 27, 10
PRV_BUDGETS = os.path.join(RESULTS_DIR, "prv_budgets.json")


def _committed_pretrain_log(art: str = ARTIFACTS) -> list:
    with open(os.path.join(art, "prvnet_tiny720_pretrain_ckpt", "pretrain_log.jsonl")) as f:
        return [json.loads(line)["l1_mean"] for line in f]


def _log_l1(path: str) -> list:
    with open(path) as f:
        return [json.loads(line)["l1_mean"] for line in f]


def dataset_record(ds: dict, root: str, wall_s: float) -> dict:
    """What stage (a) keeps: the object counts of both datasets, the hd
    links and drops, the objects whose hd 5-view set exists."""
    cfg = pipeline_config(root)
    names = list(ds["labels"]) + list(ds["test"])
    hd5 = [n for n in names
           if os.path.exists(os.path.join(cfg.replace(name_of_pcd=n).gt_path, "hd", f"{HD_INIT_VIEWS}.json"))]
    hd = ds["hd"]
    return dict(n_names=ds["n_names"], n_loaded=ds["n_loaded"], n_train=len(ds["train"]), n_val=len(ds["val"]),
                n_test=len(ds["test"]), hd_views=HD_VIEWS, hd_camera="1280x720 model 2 (CameraConfig())",
                hd5_objects=len(hd5), hd_linked=len(hd["linked"]), hd_dropped=hd["dropped"],
                hd_train=len(hd["train"]), hd_val=len(hd["val"]), wall_s=wall_s)


def dataset_ok(rec: dict) -> bool:
    n_all = N_TRAIN + N_VAL + N_TEST
    return (rec["n_names"] == rec["n_loaded"] == rec["hd5_objects"] == n_all and not rec["hd_dropped"]
            and (rec["hd_linked"], rec["hd_train"], rec["hd_val"]) == (N_TRAIN + N_VAL, N_TRAIN, N_VAL))


def recipe_record(art: dict, out_dir: str, probe: dict = None) -> dict:
    """Stage (c)'s artifact beside the committed tiny@720 record: best val
    L1, correlation and span, the committed logs at the run's epochs, the
    pretrain's log, and the full protocol's wall projected from the
    seconds an epoch (the probe's one-epoch run, where given, takes out
    what does not grow with the epochs)."""
    make_pre, make_reg, full_pre, full_reg = RECIPES[RECIPE]
    ref = committed_recipe(recipe=RECIPE)
    ref_pre = _committed_pretrain_log()
    n_pre, n_reg = art["pretrain_epochs"], art["epochs"]
    pre_cfg, reg_cfg = make_pre(art["seed"], n_pre), make_reg(art["seed"], n_reg)
    rec = {k: v for k, v in art.items() if k != "val_per_object"}
    rec.update(
        cut=(n_pre, n_reg) != (full_pre, full_reg), full_epochs=[full_pre, full_reg],
        micro_batches=dict(pretrain=f"{pre_cfg.accum_steps} x {pre_cfg.micro_batch} images",
                           regression=f"{reg_cfg.accum_steps} x {reg_cfg.micro_batch} objects",
                           reference="8 x 8 in both stages"),
        val_pred_span=art["val_pred_min_max"][1] - art["val_pred_min_max"][0],
        pretrain_l1_by_epoch=_log_l1(os.path.join(out_dir, "pretrain", "pretrain_log.jsonl")),
        predictions=prediction_table({str(art["seed"]): art}, ref),
        committed=dict(best_val_l1_mean=ref["best_val_l1_mean"], val_pred_gt_corr=ref["val_pred_gt_corr"],
                       val_pred_min_max=ref["val_pred_min_max"], pretrain_best_l1=ref["pretrain_best_l1"],
                       pretrain_seconds=ref["pretrain_seconds"], train_seconds=ref["train_seconds"],
                       val_l1_at_epochs=ref["val_l1_by_epoch"][n_reg - 1],
                       best_val_l1_within_epochs=min(ref["val_l1_by_epoch"][:n_reg]),
                       pretrain_best_l1_within_epochs=min(ref_pre[:n_pre])),
    )
    per = {}
    for stage, key, n, full in (("pretrain", "pretrain_seconds", n_pre, full_pre),
                                ("regression", "train_seconds", n_reg, full_reg)):
        if probe and n > 1:
            per_epoch = (art[key] - probe[key]) / (n - 1)
            fixed = probe[key] - per_epoch
        else:
            per_epoch, fixed = art[key] / n, 0.0
        per[stage] = dict(seconds_an_epoch=per_epoch, fixed_seconds=fixed, projected_full_s=fixed + full * per_epoch)
    per["projected_full_hours"] = (per["pretrain"]["projected_full_s"] + per["regression"]["projected_full_s"]) / 3600
    rec["projection"] = per
    return rec


def mode7_job(job: tuple) -> dict:
    """(root, name, budget, device): mode 7's PRV field of ``name`` at
    ``budget`` in a worker process."""
    root, name, budget, device = job
    torch.set_num_threads(1)
    return dict(name=name, budget=budget, **score_budget(pipeline_config(root), name, budget, 0, device))


def mode21_job(job: tuple) -> dict:
    """(root, name, checkpoint, device): mode 21's method 4 of ``name``
    through the live predictor in a worker process."""
    root, name, checkpoint, device = job
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    rows = run_rows(mode21_config(root), [name], (4,), live_predictor(checkpoint, ARCH, HD_CROP, device=device),
                    device=device)
    return dict(name=name, row=rows[f"{name}/m4"], wall_s=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(WORKSPACE, "hd_check"))
    ap.add_argument("--stages", nargs="+", choices=STAGES, default=list(DEFAULT_STAGES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pretrain-epochs", type=int, default=None, help="default: the recipe's 100")
    ap.add_argument("--epochs", type=int, default=None, help="default: the recipe's 800")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "hd_check.json"))
    ap.add_argument("--tiny720-out", default=os.path.join(RESULTS_DIR, "tiny720.json"))
    ap.add_argument("--log", default=os.path.join(LOG_DIR, "hd_check.log"))
    args = ap.parse_args(argv)
    device = require_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    log = Log(args.log)
    card = card_line()
    _, _, full_pre, full_reg = RECIPES[RECIPE]
    n_pre = full_pre if args.pretrain_epochs is None else args.pretrain_epochs
    n_reg = full_reg if args.epochs is None else args.epochs
    result = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            result = json.load(f)
    result["card"] = card
    result["cards"] = sorted(set(result.get("cards", [])) | {card})
    todo = [s for s in STAGES if s in args.stages and s not in result]
    log(f"hd check on {card}; stages to run {todo} (done: {[s for s in STAGES if s in result]}), workspace "
        f"{args.root}, recipe {RECIPE} at {n_pre} + {n_reg} epochs, seed {args.seed}")

    def save():
        write_json(args.out, result, LOG_DIR)

    build_kernels(device)
    ds = None
    if set(todo) & {"a", "probe", "c", "e", "f"}:
        t0 = time.perf_counter()
        ds = prepare_dataset(args.root, args.workers, device, hd=True)
        rec = dataset_record(ds, args.root, time.perf_counter() - t0)
        log(f"(a) the hd sets: {json.dumps(rec)}")
        if "a" in result and {k: v for k, v in rec.items() if k != "wall_s"} != {
                k: v for k, v in result["a"].items() if k != "wall_s"}:
            raise SystemExit(f"(a) this call's hd sets differ from the recorded ones: {result['a']}")
        result.setdefault("a", rec)
        save()
        if not dataset_ok(rec):
            raise SystemExit(f"(a) the hd sets are not the committed corpus's: {rec}")

    if "b" in todo:
        t0 = time.perf_counter()
        got = dict(card=card, **tiny720.run(device))
        write_json(args.tiny720_out, got, LOG_DIR)
        held = got["attempts"][-1]
        result["b"] = dict(held, batch_held=got["batch_held"], out_of_memory=[a["batch_size"] for a in
                                                                              got["attempts"][:-1]],
                           **{k: v for k, v in got.items() if k.startswith("epoch_seconds")},
                           wall_s=time.perf_counter() - t0)
        save()
        log(f"(b) tiny@720 step: {json.dumps(result['b'])}")

    if "probe" in todo:
        art = run_two_stage(ds["hd"]["root"], os.path.join(args.root, f"{RECIPE}_probe"), seed=args.seed,
                            pretrain_epochs=1, epochs=1, device=device, recipe=RECIPE, log_every=1)
        result["probe"] = {k: art[k] for k in ("pretrain_epochs", "epochs", "pretrain_seconds", "train_seconds",
                                               "pretrain_best_l1", "best_val_l1_mean", "n_train", "n_val")}
        save()
        log(f"(probe) one epoch of each stage: {json.dumps(result['probe'])}")

    out_dir = os.path.join(args.root, f"{RECIPE}_seed{args.seed}_p{n_pre}_e{n_reg}")
    checkpoint = os.path.join(out_dir, "regression", "best_checkpoint.msgpack")
    if "c" in todo or ({"e", "f"} & set(todo) and not os.path.exists(checkpoint)):
        art = run_two_stage(ds["hd"]["root"], out_dir, seed=args.seed, pretrain_epochs=n_pre, epochs=n_reg,
                            device=device, recipe=RECIPE, log_every=10)
        result["c"] = recipe_record(art, out_dir, result.get("probe"))
        save()
        c = result["c"]
        log(f"(c) tiny@720 at {n_pre} + {n_reg} epochs: best val L1 {c['best_val_l1_mean']:.4f} (committed "
            f"{c['committed']['best_val_l1_mean']} at 800, {c['committed']['best_val_l1_within_epochs']:.4f} within "
            f"{n_reg}), corr {c['val_pred_gt_corr']:.4f} (committed {c['committed']['val_pred_gt_corr']}), "
            f"span {c['val_pred_span']:.2f}; pretrain {c['pretrain_seconds']:.1f} s, regression "
            f"{c['train_seconds']:.1f} s; full protocol projected {c['projection']['projected_full_hours']:.2f} h")

    if "d" in todo:
        try:
            a = predictor_gate(os.path.join(out_dir, "result.json"))
            result["d"] = dict(passed=True, corr=a["val_pred_gt_corr"], span=result["c"]["val_pred_span"])
        except SystemExit as refused:
            result["d"] = dict(passed=False, reason=str(refused))
        save()
        log(f"(d) gate: {json.dumps(result['d'])}")

    if "e" in todo:
        t0 = time.perf_counter()
        budgets = predict_test_budgets(pipeline_config(args.root), corpus_roster()["test"], checkpoint, device, arch=ARCH,
                                       crop=HD_CROP)
        result["e"] = dict(budgets=budgets, committed_tiny720_budgets=committed_predictions(),
                           wall_s=time.perf_counter() - t0)
        if os.path.exists(PRV_BUDGETS):
            with open(PRV_BUDGETS) as f:
                result["e"]["port_tiny180_budgets"] = json.load(f).get("budgets")
        save()
        log(f"(e) live budgets: {json.dumps(budgets)}; committed tiny@720 {json.dumps(committed_predictions())}")

    if "f" in todo:
        if not result.get("d", {}).get("passed"):
            result["f"] = dict(run=False, reason="the gate (d) refused the predictor: as exp_mode7_r4.py and "
                                                 "exp_mode21_r4.py, no rows are written with it")
            save()
            log(f"(f) not run: {result['f']['reason']}")
            return 0
        cfg = pipeline_config(args.root)
        install_eval_viewspace(cfg)
        install_eval_viewspace(mode21_config(args.root))
        from ..scene.object_setup import _ensure_viewspace

        _ensure_viewspace(cfg.viewspace_path, cfg.num_of_views, device)
        budgets, objects = result["e"]["budgets"], pick_objects(5)
        for name in sorted(set(budgets) | set(objects)):
            make_family_object(name, model_dir(cfg))
        ref7, ref21 = committed_mode7()["rows"], committed_mode21()["rows"]
        t0 = time.perf_counter()
        rows7 = {}
        for rec in run_jobs(mode7_job, [(args.root, n, b, str(device)) for n, b in budgets.items()], args.workers):
            rows7[rec["name"]] = dict(port={k: rec[k] for k in ("budget", "PSNR", "SSIM", "path_len", "wall_s")},
                                      committed=ref7[rec["name"]]["prv"])
            log(f"(f) mode 7 PRV {rec['name']}: {json.dumps(rows7[rec['name']])}")
        wall7 = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows21 = {}
        for rec in run_jobs(mode21_job, [(args.root, n, checkpoint, str(device)) for n in objects], args.workers):
            rows21[f"{rec['name']}/m4"] = dict(port=dict(rec["row"], wall_s=rec["wall_s"]),
                                               committed=ref21[f"{rec['name']}/m4"],
                                               budget_as_e=rec["row"].get("budget") == budgets.get(rec["name"]))
            log(f"(f) mode 21 m4 {rec['name']}: {json.dumps(rows21[rec['name'] + '/m4'])}")
        result["f"] = dict(run=True, mode7_prv=rows7, mode7_wall_s=wall7, mode21_m4=rows21,
                           mode21_wall_s=time.perf_counter() - t0, workers=args.workers)
        save()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
