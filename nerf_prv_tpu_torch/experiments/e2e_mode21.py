"""End-to-end mode 21 on the port at production width: the PRV method, the
random baseline and the ensemble-NeRF baseline on ``toy0``.

Counterpart of ``experiments/exp_e2e_mode21.py``: the default 1280x720
model-2 camera, 2,500-step fields of the default voxel field, a 60-view
candidate space, ``ensemble_num=2``, 3 iterations at most where no budget
is replayed, ``evaluate=False`` by default.  Mode 0 writes the view spaces
5, 60 and 13..58 (``:41``); mode 21 runs methods (4, 0, 2) from the init
views (0, 1, 3) with no coverage sets beyond the 60-view space and the 5
init views (``:64-72``).  Methods 0 and 2 replay method 4's budget.

The predictor (``:43-62``): the checkpoint at ``checkpoint`` where one is
given and exists (atto, ``IMG_PATTERN[2]``, crop 180); otherwise a fresh
atto drawn from ``TrainConfig.seed`` at crop 64 (``init_model``,
``TrainConfig(arch="convnextv2_atto", image_size=64)``).

    python -m nerf_prv_tpu_torch.experiments.e2e_mode21 [--root DIR] [--checkpoint PATH] [--evaluate]

It prints and returns each method's budget and ``run_time`` as the
script does (``:73-84``).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

from ..core.config import Config
from ..nerf.model import NerfConfig
from ..pipeline import modes
from .label_protocol import require_device
from .runs import WORKSPACE
from .toy import TOY_NAME, write_toy

METHODS = (4, 0, 2)
INIT_CASE = (0, 1, 3)
VIEW_SIZES = [5, 60] + list(range(13, 59))
PREDICTOR_ARCH = "convnextv2_atto"


def e2e_config(root: str, evaluate: bool = False) -> Config:
    """The script's configuration under ``root`` (≙ exp_e2e_mode21.py:30-40)."""
    return Config(
        workspace=os.path.join(root, "ws"),
        model_path=os.path.join(root, "models"),
        viewspace_path=os.path.join(root, "ws", "viewspace"),
        name_of_pcd=TOY_NAME,
        num_of_views=60,
        num_of_max_iteration=3,
        n_steps=2500,
        ensemble_num=2,
        evaluate=evaluate,
    )


def make_predictor(checkpoint: Optional[str] = None, device="cuda", seed: int = 0):
    """(predictor, kind): the checkpoint's atto at crop 180 where
    ``checkpoint`` exists, else a fresh atto at crop 64 drawn from ``seed``
    (≙ exp_e2e_mode21.py:43-62)."""
    from ..prvnet.infer import BudgetPredictor
    from ..prvnet.model import IMG_PATTERN
    from ..prvnet.train import TrainConfig, init_model

    if checkpoint and os.path.exists(checkpoint):
        return BudgetPredictor(checkpoint_path=checkpoint, arch=PREDICTOR_ARCH, pattern=IMG_PATTERN[2], crop=180,
                               device=device), "checkpoint"
    model = init_model(TrainConfig(arch=PREDICTOR_ARCH, image_size=64, seed=seed), n_views=3, image_size=64)
    return BudgetPredictor(params=model.state_dict(), arch=PREDICTOR_ARCH, pattern=IMG_PATTERN[2], crop=64,
                           device=device), "fresh-init"


def read_method(path: str) -> dict:
    """One method's budget (``view_budget.txt``, else None) and
    ``run_time`` (``run_time.txt``, else None), as the script prints them."""
    out = {}
    for key, name in (("budget", "view_budget.txt"), ("run_time", "run_time.txt")):
        f = os.path.join(path, name)
        out[key] = float(open(f).read().split()[0]) if os.path.exists(f) else None
    if out["budget"] is not None:
        out["budget"] = int(out["budget"])
    return out


def run_e2e(root: str, checkpoint: Optional[str] = None, evaluate: bool = False,
            methods: Sequence[int] = METHODS, device="cuda", cfg: Optional[Config] = None,
            nerf_cfg: Optional[NerfConfig] = None, predictor=None, coverage_sizes: Sequence[int] = ()) -> dict:
    """The script under ``root``: ``toy0``'s PLY, mode 0, then mode 21 for
    ``methods``.  ``cfg`` replaces the script's configuration, ``nerf_cfg``
    its field (``NerfConfig(n_steps=cfg.n_steps)``), ``predictor`` the
    script's rule and ``coverage_sizes`` the sets mode 21 renders besides
    the candidate space and the 5 init views.  Returns {elapsed_s,
    predictor, methods: {method: {path, budget, run_time}}}."""
    device = require_device(device)
    write_toy(root)
    cfg = cfg or e2e_config(root, evaluate=evaluate)
    modes.mode_view_cover(cfg, sizes=VIEW_SIZES, device=device)
    kind = "given"
    if predictor is None:
        predictor, kind = make_predictor(checkpoint, device)
        print(f"using {kind} PRVNet weights" + (f" ({checkpoint})" if kind == "checkpoint" else ""), flush=True)
    t0 = time.perf_counter()
    paths = modes.mode_view_planning(cfg, [TOY_NAME], method_ids=tuple(methods), init_view_cases=(INIT_CASE,),
                                     predictor=predictor, nerf_cfg=nerf_cfg, coverage_sizes=coverage_sizes,
                                     device=device)
    elapsed = time.perf_counter() - t0
    print(f"mode21 methods {tuple(methods)}: {elapsed:.1f}s", flush=True)
    rows = {}
    for method, path in zip(methods, paths):
        rows[method] = dict(path=path, **read_method(path))
        r = rows[method]
        print(f"  {os.path.basename(path)}: budget={r['budget'] if r['budget'] is not None else '-'} "
              f"run_time={r['run_time'] if r['run_time'] is not None else '-'}", flush=True)
    return dict(elapsed_s=elapsed, predictor=kind, methods=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(WORKSPACE, "e2e_ws"))
    ap.add_argument("--checkpoint", default=None, help="an atto@180 best_checkpoint.msgpack")
    ap.add_argument("--evaluate", action="store_true", help="train and score each method's final field")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run_e2e(args.root, args.checkpoint, evaluate=args.evaluate, device=args.device)
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
