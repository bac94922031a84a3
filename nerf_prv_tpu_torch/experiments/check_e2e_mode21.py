"""The end-to-end mode-21 check: ``e2e_mode21`` on the card at production
width, with each method's final field trained and scored.

    python -m nerf_prv_tpu_torch.experiments.check_e2e_mode21 [--methods 4 0 2] [--checkpoint PATH]

The script's configuration (``toy0``, the 1280x720 model-2 camera, 2,500-step
fields, a 60-view candidate space, ``ensemble_num=2``, methods 4, 0 and 2
from the init views 0, 1, 3, the predictor by the script's rule) with
``evaluate=True``, so that each method's last iteration trains a field on
the views it chose and scores it on the 100-view set.  Deviations from the
script, stated in the result: the budget's coverage set and the 100-view
set are rendered before the loop (the script, which does not evaluate,
renders neither), and the view spaces 5..60 are the files the reference's
workspace held (``mode7_compare.install_eval_viewspace``), so that every
call plans on the same ones; mode 0 writes none.

On the card, in this order:
1. Preparation: the PLY, the object's load with its size test, the 60- and
   5-view sets, the budget the predictor gives from views 0, 1, 3, the
   budget's set and the 100-view set; K8's launches (one a size-test try,
   one a set) derived and met.
2. Each method of ``--methods`` in that order (4 first where it runs;
   methods 0 and 2 replay its budget, which a later call restores from the
   result file): the number of fields and screenshots derived from the
   budget before the run, then the ``row_gather`` and ``row_scatter_add``
   launches from the code (``launches``: each training's, each eval's and
   each screenshot's, their data counted by replaying the compaction) and
   met exactly; the chosen views in order, the movement per iteration and
   in total, ``run_time`` and each iteration's ``infer_time``, the final
   PSNR and SSIM beside an all-black frame's.
3. Method 2: each iteration's choice recomputed from its screenshots with
   the plain score (``score_candidates_rgb`` on the CPU), which must agree
   with the card's argmax.

A method is done once it has a row and is not run again, so the methods can
be split over calls.  The workspace is ``.workspace/e2e_mode21_check``, the
result ``nerf_prv_tpu_torch/experiments/results/e2e_mode21_check.json``; the
log and a copy go to the gitignored ``runs.LOG_DIR``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Dict, List

import numpy as np

from ..ops.row_gather import row_gather
from ..ops.row_scatter_add import row_scatter_add
from ..ops.splat import splat
from ..pipeline import nbv as nbv_mod
from . import launches as launch_mod
from .e2e_mode21 import INIT_CASE, METHODS, e2e_config, make_predictor, run_e2e
from .label_protocol import require_device
from .runs import LOG_DIR, RESULTS_DIR, WORKSPACE, Log, black_psnr, build_kernels, card_line, write_json
from .toy import TOY_NAME, write_toy

DEVIATIONS = [
    "evaluate=True: each method's last iteration trains a field on its views and scores it on the 100-view set",
    "the budget's coverage set and the 100-view set are rendered before the loop",
    "view spaces 5..60: the files the reference's workspace held (install_eval_viewspace), not mode 0's draws",
]


def field_config(cfg):
    """The NBV loop's field: the default voxel field, ``cfg.n_steps`` steps."""
    from ..nerf.model import NerfConfig

    return NerfConfig(n_steps=cfg.n_steps)


WRAPPERS = (row_gather, row_scatter_add, splat)  # the kernels on this path, each counting its launches


def counts() -> Dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


@contextlib.contextmanager
def nbv_recorder(trainings: list, evals: list, shots: list):
    """Record, while mode 21 runs: each field the NBV loop trains (its
    scene json), each ``eval_nerf`` (params, test set, config, the gathers it
    launched) and each ``screenshot_nerf`` (render json, config, gathers)."""
    real = dict(train=nbv_mod.train_nerf, eval=nbv_mod.eval_nerf, shot=nbv_mod.screenshot_nerf)

    def train(scene_json, *a, **kw):
        trainings.append(scene_json)
        return real["train"](scene_json, *a, **kw)

    def evaluate(params, test, ncfg=None):
        before = row_gather.launches
        out = real["eval"](params, test, ncfg)
        evals.append((params, test, ncfg, row_gather.launches - before))
        return out

    def shoot(params, render_json, out_dir, ncfg=None):
        before = row_gather.launches
        out = real["shot"](params, render_json, out_dir, ncfg)
        shots.append((render_json, ncfg, row_gather.launches - before))
        return out

    nbv_mod.train_nerf, nbv_mod.eval_nerf, nbv_mod.screenshot_nerf = train, evaluate, shoot
    try:
        yield
    finally:
        nbv_mod.train_nerf, nbv_mod.eval_nerf, nbv_mod.screenshot_nerf = real["train"], real["eval"], real["shot"]


def planned_work(method: int, budget: int, cfg) -> dict:
    """Fields and screenshot sets one method's run makes, from the code
    (``nbv_loop``): budget - 1 iterations; methods 2 and 3 train and
    screenshot ``ensemble_num_for_method`` fields an iteration; with
    ``evaluate`` the last iteration trains one field more and scores it."""
    iters = budget - 1
    members = cfg.replace(method_of_IG=method).ensemble_num_for_method if method in (2, 3) else 0
    return dict(iterations=iters, fields=iters * members + int(cfg.evaluate), screenshots=iters * members,
                evals=int(cfg.evaluate))


def expected_launches(trainings: list, evals: list, shots: list, nerf_cfg, dev) -> tuple:
    """(row_gather, row_scatter_add) the recorded run must have launched:
    each training's, each eval's and each screenshot's gathers from the code
    (``launches``); and each recorded call's own gathers beside the
    replay's."""
    want_g, want_s = launch_mod.train_launches(nerf_cfg)
    eval_want = [launch_mod.eval_gathers(p, t, c or nerf_cfg, dev) for p, t, c, _ in evals]
    shot_want = [launch_mod.screenshot_gathers(None, j, c or nerf_cfg, dev) for j, c, _ in shots]
    gathers = len(trainings) * want_g + sum(e for e, _ in eval_want) + sum(s for s, _ in shot_want)
    per_call = dict(evals=[(g, e) for (*_, g), (e, _) in zip(evals, eval_want)],
                    screenshots=[(g, s) for (*_, g), (s, _) in zip(shots, shot_want)],
                    eval_data=[d for _, d in eval_want], screenshot_hits=[sum(d) for _, d in shot_want])
    return {"row_gather": gathers, "row_scatter_add": len(trainings) * want_s}, per_call


def read_path(path: str) -> dict:
    """A method's choices, movements, times and final metrics off its
    experiment directory."""
    from ..nerf.api import load_metrics

    mv = os.path.join(path, "movement")
    moves = sorted(int(f[:-4]) for f in os.listdir(mv) if f[:-4].isdigit())
    rows = [open(os.path.join(mv, f"{i}.txt")).read().split() for i in moves]
    first = open(os.path.join(mv, "-1.txt")).read().split()
    it_dir = os.path.join(path, "infer_time")
    out = dict(first_view=int(first[0]), chosen=[int(r[0]) for r in rows], movement=[float(r[1]) for r in rows],
               movement_total=float(rows[-1][2]) if rows else 0.0,
               infer_time=[float(open(os.path.join(it_dir, f"{i}.txt")).read()) for i in moves],
               run_time=float(open(os.path.join(path, "run_time.txt")).read()))
    mdir = os.path.join(path, "metrics")
    finals = sorted((f for f in os.listdir(mdir) if f.endswith(".txt")), key=lambda f: int(f[:-4]))
    if finals:
        m = load_metrics(os.path.join(mdir, finals[-1]))
        out.update(PSNR=m["PSNR"], SSIM=m["SSIM"], n_views_trained=int(finals[-1][:-4]) + 1)
    bud = os.path.join(path, "view_budget.txt")
    if os.path.exists(bud):
        out["budget"] = int(open(bud).read().split()[0])
    return out


def ensemble_choices(path: str, first: int, chosen: List[int], n_views: int, members: int) -> list:
    """Each iteration's choice recomputed from its screenshots with the plain
    score on the CPU (``score_candidates_rgb``), as ``nbv_loop`` stacks them:
    [{iteration, card, plain, top2_gap}]."""
    import torch
    from PIL import Image

    out, taken = [], [first]
    for it, card in enumerate(chosen):
        cands = [i for i in range(n_views) if i not in taken]
        dirs = [os.path.join(path, "render", str(it), f"ensemble_{e}") for e in range(members)]
        imgs = np.stack([np.stack([np.asarray(Image.open(os.path.join(d, f"rgbaClip_{i}.png")).convert("RGBA"))
                                   for d in dirs]) for i in cands])
        scores = nbv_mod.score_candidates_rgb(torch.as_tensor(imgs)).numpy().astype(np.float64)
        top = np.sort(scores)[::-1]
        out.append(dict(iteration=it, card=card, plain=cands[int(np.argmax(scores))],
                        top2_gap=float(top[0] - top[1]) if len(top) > 1 else None))
        taken.append(card)
    return out


def prepare(cfg, predictor, dev, budget=None) -> dict:
    """The object's load (size test), the 60- and 5-view sets, the budget
    (the predictor's from views 0, 1, 3, or ``budget``), its set and the
    100-view set, with K8's launches against the code."""
    from ..pipeline import coverage as coverage_mod
    from ..scene import object_setup as object_setup_mod

    tries = []
    real_size = object_setup_mod._size_test_rate

    def size_test(*a, **kw):
        tries.append(1)
        return real_size(*a, **kw)

    object_setup_mod._size_test_rate = size_test
    reset_counts()
    t0 = time.perf_counter()
    try:
        scene = object_setup_mod.load_object(cfg, TOY_NAME, device=dev)
    finally:
        object_setup_mod._size_test_rate = real_size
    for n in (cfg.num_of_views, 5):
        coverage_mod.get_coverage(scene, cfg, n, device=dev)
    value = predictor.predict_value_from_arrays(predictor.coverage_views(os.path.join(cfg.gt_path, "5"), INIT_CASE))
    predicted = int(np.round(value))
    budget = predicted if budget is None else budget
    sets = [cfg.num_of_views, 5] + [n for n in (budget, 100) if n not in (cfg.num_of_views, 5)]
    for n in sets[2:]:
        coverage_mod.get_coverage(scene, cfg, n, device=dev)
    got = counts()["splat"]
    return dict(budget=budget, predicted_value=value, predicted=predicted, size_test_tries=len(tries), sets=sets,
                splat=dict(launched=got, expected=len(tries) + len(sets)), wall_s=time.perf_counter() - t0)


def main(argv=None) -> int:
    from .mode7_compare import install_eval_viewspace

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--methods", type=int, nargs="+", default=list(METHODS))
    ap.add_argument("--root", default=os.path.join(WORKSPACE, "e2e_mode21_check"))
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "e2e_mode21_check.json"))
    ap.add_argument("--log", default=os.path.join(LOG_DIR, "e2e_mode21_check.log"))
    args = ap.parse_args(argv)
    device = require_device(args.device)
    log = Log(args.log)
    card = card_line()
    result = dict(card=card, cards=[card], deviations=DEVIATIONS, methods={})
    if os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        result.update(prev, card=card)
        result["cards"] = sorted(set(prev.get("cards", [])) | {card})
    build_kernels(device)
    cfg = e2e_config(args.root, evaluate=True)
    nerf_cfg = field_config(cfg)
    write_toy(args.root)
    install_eval_viewspace(cfg)
    predictor, kind = make_predictor(args.checkpoint, device)
    stored = result.get("budget")
    prep = prepare(cfg, predictor, device, budget=stored)
    result.setdefault("calls", []).append(dict(card=card, methods=args.methods, predictor=kind, prepare=prep))
    result.update(predictor=kind, budget=prep["budget"], predicted_value=prep["predicted_value"],
                  configuration=dict(camera=f"{cfg.camera.width}x{cfg.camera.height} model {cfg.camera.model}",
                                     n_steps=cfg.n_steps, num_of_views=cfg.num_of_views, ensemble_num=cfg.ensemble_num,
                                     init_views=list(INIT_CASE), methods=list(METHODS), evaluate=True))
    write_json(args.out, result, LOG_DIR)
    log(f"e2e mode 21 check on {card}: {kind} predictor, budget {prep['budget']} (continuous "
        f"{prep['predicted_value']:.4f}); preparation {prep['wall_s']:.1f} s, K8 {prep['splat']} "
        f"({prep['size_test_tries']} size-test tries + sets {prep['sets']})")
    ok = prep["splat"]["launched"] == prep["splat"]["expected"] and prep["predicted"] == prep["budget"]
    if not ok:
        log("FAILED: K8's launches or the budget are not the ones expected")

    black = black_psnr(os.path.join(cfg.gt_path, "100.json"))
    for method in args.methods:
        if str(method) in result["methods"]:
            log(f"method {method}: in the result file already")
            continue
        mcfg = cfg.replace(method_of_IG=method)
        if method != 4:  # the replayed budget (a later call's workspace lacks method 4's run)
            m4 = f"{cfg.replace(method_of_IG=4).save_path}_v{len(INIT_CASE)}_t0"
            os.makedirs(m4, exist_ok=True)
            if not os.path.exists(os.path.join(m4, "view_budget.txt")):
                with open(os.path.join(m4, "view_budget.txt"), "w") as f:
                    f.write(f"{prep['budget']}\n")
        plan = planned_work(method, prep["budget"], mcfg)
        log(f"method {method} ({nbv_mod.METHOD_NAMES[method]}): derived before the run: {json.dumps(plan)}")
        trainings, evals, shots = [], [], []
        reset_counts()
        t0 = time.perf_counter()
        with nbv_recorder(trainings, evals, shots):
            out = run_e2e(args.root, methods=(method,), device=device, cfg=cfg, nerf_cfg=nerf_cfg,
                          predictor=predictor, coverage_sizes=[prep["budget"], 100])
        wall = time.perf_counter() - t0
        launched = counts()
        want, per_call = expected_launches(trainings, evals, shots, nerf_cfg, device)
        want["splat"] = 0
        row = dict(read_path(out["methods"][method]["path"]), wall_s=wall, planned=plan, launched=launched,
                   expected=want, per_call=per_call, black_psnr=black)
        row["launches_equal"] = (launched == want and len(trainings) == plan["fields"]
                                 and len(shots) == plan["screenshots"] and len(evals) == plan["evals"]
                                 and all(g == e for g, e in per_call["evals"] + per_call["screenshots"]))
        if method in (2, 3):
            choices = ensemble_choices(out["methods"][method]["path"], row["first_view"], row["chosen"],
                                       cfg.num_of_views, mcfg.ensemble_num_for_method)
            row["plain_choices"] = choices
            row["plain_equal"] = all(c["card"] == c["plain"] for c in choices)
            log(f"method {method}: plain score argmax equal to the card's at "
                f"{sum(c['card'] == c['plain'] for c in choices)} of {len(choices)} iterations (smallest top-2 gap "
                f"{min(c['top2_gap'] for c in choices):.4g})")
        result["methods"][str(method)] = row
        write_json(args.out, result, LOG_DIR)
        log(f"method {method}: {wall:.1f} s; budget {row.get('budget', prep['budget'])}, chose {row['chosen']}, "
            f"movement {row['movement_total']:.6f}, run_time {row['run_time']:.2f} s, PSNR {row.get('PSNR')} SSIM "
            f"{row.get('SSIM')} (black {black:.3f} dB); launches {launched}, derived {want}: "
            f"{'equal' if row['launches_equal'] else 'DIFFERENT'}")
        ok = ok and row["launches_equal"] and row.get("plain_equal", True)
    result["all_held"] = ok and all(r["launches_equal"] and r.get("plain_equal", True)
                                    for r in result["methods"].values())
    write_json(args.out, result, LOG_DIR)
    log(f"summary ({card}): methods {sorted(result['methods'])}, all held {result['all_held']}")
    return 0 if result["all_held"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
