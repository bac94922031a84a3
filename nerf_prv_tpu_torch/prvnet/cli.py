"""PRVNet trainer CLI: ``python -m nerf_prv_tpu_torch.prvnet.cli``.

Counterpart of ``nerf_prv_tpu/prvnet/cli.py``, with its argument surface
(≙ ``PRVNet/train_regression.py:256-337``): regression training by default,
``--pre_train`` for the single-view PVBPretrain stage, ``--ImageNet`` /
``--premodel_file`` for encoder initialization, ``--resnet50`` /
``--resnet101`` encoder alternatives; plus ``--device``.  As the JAX CLI,
it trains data-parallel over every device by default (every CUDA card
here); ``--device cuda:1`` trains on one named card and ``--device cpu`` on
the CPU.  Checkpoints are the JAX package's ``.msgpack`` files.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="PVBNet / PVBPretrain trainer")
    p.add_argument("--data_path", required=True, help="pvb_dataset root")
    p.add_argument("--train_split", default=None, help="train split txt "
                   "(default <data_path>/train_split.txt)")
    p.add_argument("--val_split", default=None, help="val split txt "
                   "(default <data_path>/val_split.txt)")
    p.add_argument("--model", default="convnextv2_tiny",
                   help="encoder arch (convnextv2_*, resnet50, resnet101)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--blr", type=float, default=1.5e-4)
    p.add_argument("--min_lr", type=float, default=0.0)
    p.add_argument("--warmup_epochs", type=int, default=40)
    p.add_argument("--use_schedule", action="store_true",
                   help="enable the (reference-dormant) warmup+cosine schedule")
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--epochs", type=int, default=800)
    p.add_argument("--loss_type", default="L1", choices=("L1", "MSE"))
    p.add_argument("--input_size", type=int, default=720, help="center crop")
    p.add_argument("--pattern_idx", type=int, default=4,
                   help="IMG_PATTERN index (0-4), ≙ --pattern_idx")
    p.add_argument("--output_dir", default="checkpoints")
    p.add_argument("--pre_train", action="store_true",
                   help="single-view PVBPretrain stage (≙ --pre_train)")
    p.add_argument("--viewspace_size", type=int, default=64,
                   help="views per object for the pretrain dataset")
    p.add_argument("--premodel_file", default="",
                   help="encoder init checkpoint (.pth or .msgpack)")
    p.add_argument("--ImageNet", action="store_true", dest="imagenet",
                   help="premodel_file is an ImageNet encoder checkpoint")
    p.add_argument("--resnet50", action="store_true")
    p.add_argument("--resnet101", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="one torch device to train on (cuda:N or cpu); default: every CUDA card, data-parallel")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    import os

    args = parse_args(argv)
    from ..parallel.mesh import make_mesh
    from .model import IMG_PATTERN
    from .train import TrainConfig, pretrain, train_regression

    arch = args.model
    if args.resnet101:
        arch = "resnet101"
    elif args.resnet50:
        arch = "resnet50"
    cfg = TrainConfig(
        arch=arch,
        batch_size=args.batch_size,
        blr=args.blr,
        min_lr=args.min_lr,
        warmup_epochs=args.warmup_epochs,
        use_schedule=args.use_schedule,
        weight_decay=args.weight_decay,
        epochs=args.epochs,
        loss_type=args.loss_type,
        image_size=args.input_size,
        seed=args.seed,
    )
    mesh = make_mesh(devices=[args.device] if args.device else None)
    train_split = args.train_split or os.path.join(args.data_path, "train_split.txt")
    val_split = args.val_split or os.path.join(args.data_path, "val_split.txt")
    if args.pre_train:
        _, best = pretrain(
            args.data_path, train_split,
            val_split if os.path.exists(val_split) else None,
            cfg=cfg, checkpoint_dir=args.output_dir, mesh=mesh,
            viewspace_size=args.viewspace_size,
        )
    else:
        _, best = train_regression(
            args.data_path, train_split, val_split,
            cfg=cfg, pattern=IMG_PATTERN[args.pattern_idx],
            checkpoint_dir=args.output_dir, mesh=mesh,
            premodel_file=args.premodel_file or None,
            imagenet=args.imagenet,
        )
    print(best)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
