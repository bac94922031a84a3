"""Command-line entry: ``python -m nerf_prv_tpu_torch.pipeline.cli``.

Counterpart of ``nerf_prv_tpu/pipeline/cli.py``: the reference's interactive
console (mode int + object names terminated by ``-1``,
``main.cpp:2294-2309``) and the JAX package's flags, plus ``--device``
(default ``cuda``; ``--device cpu`` runs every mode on the CPU).
``--checkpoint`` takes the PRVNet ``.pth``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..core.config import Config
from . import modes


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(
        description="NeRF-PRV pipeline on PyTorch (modes match the reference)"
    )
    p.add_argument("--mode", type=int, default=None, help="pipeline mode id")
    p.add_argument("--objects", nargs="*", default=[], help="object names")
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--workspace", default=None)
    p.add_argument("--n-steps", type=int, default=None, help="NeRF train steps")
    p.add_argument("--method", type=int, default=None, help="method_of_IG override")
    p.add_argument("--checkpoint", default=None, help="PRVNet checkpoint (.pth)")
    p.add_argument(
        "--sizes", type=int, nargs="*", default=None,
        help="view-space sizes for modes 0/20 (default 3..100)",
    )
    p.add_argument(
        "--warm-start-steps", type=int, default=0,
        help="mode 4: warm-start each view count from the previous one and "
        "train this many steps instead of n_steps (0 = reference-parity "
        "from-scratch retrains; it shifts the fitted label, so not for "
        "label generation)",
    )
    p.add_argument("--device", default="cuda", help="torch device for every mode (cuda or cpu)")
    p.add_argument("--interactive", action="store_true", help="reference-style stdin")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.config:
        cfg = Config.from_yaml(args.config)
    else:
        cfg = Config()
    if args.workspace:
        import os

        cfg = cfg.replace(workspace=args.workspace)
        if not args.config:  # root relative data dirs under the workspace
            cfg = cfg.replace(
                viewspace_path=os.path.join(args.workspace, "view_space", "Hemisphere"),
                model_path=os.path.join(args.workspace, "3D_models"),
            )
    if args.n_steps:
        cfg = cfg.replace(n_steps=args.n_steps)
    if args.method is not None:
        cfg = cfg.replace(method_of_IG=args.method)

    mode = args.mode
    names = list(args.objects)
    if args.interactive or mode is None:
        print("input mode:", end="", flush=True)
        mode = int(input())
        print("input models:")
        names = []
        for line in sys.stdin:
            name = line.strip()
            if name == "-1":
                break
            if name:
                names.append(name)

    predictor = None
    if args.checkpoint:
        from ..prvnet.infer import BudgetPredictor

        predictor = BudgetPredictor(args.checkpoint, device=args.device)

    sizes = args.sizes if args.sizes else range(3, 101)
    dev = args.device
    if mode == 0:
        modes.mode_view_cover(cfg, sizes=sizes, device=dev)
    elif mode == 1:
        modes.mode_view_novel(cfg, names, device=dev)
    elif mode == 2:
        modes.mode_get_size_test(cfg, names, device=dev)
    elif mode == 3:
        modes.mode_get_coverage(cfg, names, device=dev)
    elif mode == 4:
        modes.mode_instant_ngp(cfg, names, warm_start_steps=args.warm_start_steps, device=dev)
    elif mode == 5:
        modes.mode_fit_labels(cfg, names, device=dev)
        modes.mode_read_label(cfg, names)
    elif mode == 6:
        modes.mode_get_dataset(cfg, names)
    elif mode == 7:
        from ..labeling.dataset import read_sorted_object_names
        import os

        labels = read_sorted_object_names(
            os.path.join(cfg.workspace, "sorted_object_names.txt")
        )
        modes.mode_test_objects(cfg, names or list(labels), labels, predictor=predictor, device=dev)
    elif mode == 10:
        modes.mode_shapenet_preprocess(cfg, names)
    elif mode == 11:
        modes.mode_get_clean_data(cfg, names)
    elif mode == 20:
        modes.mode_get_path_plan(cfg, sizes=sizes, device=dev)
    elif mode == 21:
        method_ids = (args.method,) if args.method is not None else (4, 0, 1, 2, 3)
        modes.mode_view_planning(cfg, names, method_ids=method_ids, predictor=predictor, device=dev)
    else:
        print(f"unknown mode {mode}", file=sys.stderr)
        return 2
    print("System over.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
