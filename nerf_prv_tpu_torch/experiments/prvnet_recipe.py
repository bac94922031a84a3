"""The PRVNet recipes on the port: single-view pretrain, then regression
from the pretrained encoder, as tiny@180 and as the atto@180 corpus point.

Counterpart of ``experiments/exp_prvnet_r4.py``'s ``run_two_stage``
(``:74-160``) for ``--phase tiny180`` (``:195-205``) and of its
``_val_metrics`` (``:41``): ConvNeXt-V2 tiny on the 320x180 dataset,
CenterCrop 180.
- Pretrain: batch 64, one micro-batch, 50 epochs, blr 1.5e-3 with the
  warmup+cosine schedule, ``warmup_epochs = max(50 // 20, 2)``.
- Regression: batch 64, 800 epochs, constant blr 1.5e-4 (the reference's
  exact optimizer), five views (``IMG_PATTERN[4]``), the encoder initialised
  from the pretrain's best checkpoint.
The atto@180 arm (``--phase atto``, ``:214-230``, as ``run_r5b_queue.sh:59-67``
ran it for ``prvnet_r5_scaling.json`` with ``PRV4_PRETRAIN_BLR=1.5e-4
PRV4_PRETRAIN_SCHEDULE=0 --epochs 200``) is a second pair of configs:
ConvNeXt-V2 atto, CenterCrop 180.
- Pretrain: batch 32, one micro-batch, 2 epochs, constant blr 1.5e-4,
  ``warmup_epochs = max(2 // 20, 2)``.
- Regression: batch 8, one micro-batch, 200 epochs, constant blr 1.5e-4,
  five views.
The tiny@720 arm (``--phase tiny``, ``:168-187``), the reference's own
configuration, trains on the hd dataset (``corpus_dataset.HD_VIEWS`` views
at 1280x720): ConvNeXt-V2 tiny, CenterCrop 720, effective batch 64 in both
stages.
- Pretrain: 100 epochs, blr 1.5e-3 with the warmup+cosine schedule,
  ``warmup_epochs = max(100 // 20, 2)``, the ``HD_VIEWS`` views of each
  object as samples.
- Regression: 800 epochs, constant blr 1.5e-4, five views.
The effective batch is built from the micro-batch an H100 holds at 720
squared (about 1.8 GB an image): 16 micro-steps of 4 objects (20 images)
in the regression and 4 of 16 images in the pretrain, where the reference
takes 8 x 8 in both.  Micro-batches of one size average to the same
gradient of the same 64 samples.
It trains through the port's ``prvnet/train.py`` (``pretrain``,
``train_regression``); the seed is ``TrainConfig.seed``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ..parallel.mesh import Mesh, make_mesh, pad_to_multiple
from ..prvnet.data import PVBDataset, read_split
from ..prvnet.model import IMG_PATTERN
from ..prvnet.train import (
    TrainConfig, _load_params, init_model, load_checkpoint, make_eval_step, pretrain, train_regression,
)
from .corpus_dataset import HD_VIEWS, N_VIEWS
from .label_protocol import require_device

ARCH = "convnextv2_tiny"
CROP = 180
BATCH = 64
PRETRAIN_EPOCHS = 50
EPOCHS = 800
PRETRAIN_BLR = 1.5e-3
BLR = 1.5e-4
PATTERN = IMG_PATTERN[4]

ATTO_ARCH = "convnextv2_atto"
ATTO_BATCH = 8
ATTO_PRETRAIN_BATCH = 32
ATTO_PRETRAIN_EPOCHS = 2
ATTO_EPOCHS = 200
ATTO_PRETRAIN_BLR = 1.5e-4

HD_CROP = 720
HD_PRETRAIN_EPOCHS = 100
HD_PRETRAIN_ACCUM = 4  # 16 single views a micro-step
HD_ACCUM = 16  # 4 objects (20 views) a micro-step


def pretrain_config(seed: int = 0, epochs: int = PRETRAIN_EPOCHS) -> TrainConfig:
    """The pretrain stage's config (≙ exp_prvnet_r4.py:89-96 at tiny180)."""
    return TrainConfig(arch=ARCH, batch_size=BATCH, accum_steps=1, epochs=epochs, image_size=CROP,
                       blr=PRETRAIN_BLR, use_schedule=True, warmup_epochs=max(epochs // 20, 2), seed=seed)


def regression_config(seed: int = 0, epochs: int = EPOCHS) -> TrainConfig:
    """The regression stage's config (≙ exp_prvnet_r4.py:107-112 at tiny180)."""
    return TrainConfig(arch=ARCH, batch_size=BATCH, accum_steps=1, epochs=epochs, image_size=CROP,
                       blr=BLR, use_schedule=False, seed=seed)


def atto_pretrain_config(seed: int = 0, epochs: int = ATTO_PRETRAIN_EPOCHS) -> TrainConfig:
    """The atto arm's pretrain config (≙ exp_prvnet_r4.py:89-96 at atto with
    the queue's PRV4_PRETRAIN_BLR=1.5e-4, PRV4_PRETRAIN_SCHEDULE=0)."""
    return TrainConfig(arch=ATTO_ARCH, batch_size=ATTO_PRETRAIN_BATCH, accum_steps=1, epochs=epochs,
                       image_size=CROP, blr=ATTO_PRETRAIN_BLR, use_schedule=False,
                       warmup_epochs=max(epochs // 20, 2), seed=seed)


def atto_regression_config(seed: int = 0, epochs: int = ATTO_EPOCHS) -> TrainConfig:
    """The atto arm's regression config (≙ exp_prvnet_r4.py:107-112 at atto)."""
    return TrainConfig(arch=ATTO_ARCH, batch_size=ATTO_BATCH, accum_steps=1, epochs=epochs, image_size=CROP,
                       blr=BLR, use_schedule=False, seed=seed)


def tiny720_pretrain_config(seed: int = 0, epochs: int = HD_PRETRAIN_EPOCHS) -> TrainConfig:
    """The tiny@720 arm's pretrain config (≙ exp_prvnet_r4.py:100-106 at
    ``--phase tiny``; 4 x 16 where the reference accumulates 8 x 8)."""
    return TrainConfig(arch=ARCH, batch_size=BATCH, accum_steps=HD_PRETRAIN_ACCUM, epochs=epochs,
                       image_size=HD_CROP, blr=PRETRAIN_BLR, use_schedule=True,
                       warmup_epochs=max(epochs // 20, 2), seed=seed)


def tiny720_regression_config(seed: int = 0, epochs: int = EPOCHS) -> TrainConfig:
    """The tiny@720 arm's regression config (≙ exp_prvnet_r4.py:115-121 at
    ``--phase tiny``; 16 x 4 where the reference accumulates 8 x 8)."""
    return TrainConfig(arch=ARCH, batch_size=BATCH, accum_steps=HD_ACCUM, epochs=epochs, image_size=HD_CROP,
                       blr=BLR, use_schedule=False, seed=seed)


# recipe -> (pretrain config, regression config, pretrain epochs, regression epochs)
RECIPES = {
    "tiny180": (pretrain_config, regression_config, PRETRAIN_EPOCHS, EPOCHS),
    "atto180": (atto_pretrain_config, atto_regression_config, ATTO_PRETRAIN_EPOCHS, ATTO_EPOCHS),
    "tiny720": (tiny720_pretrain_config, tiny720_regression_config, HD_PRETRAIN_EPOCHS, EPOCHS),
}
# recipe -> the views of each object its pretrain takes as samples (the dataset's view space)
VIEWSPACE = {"tiny180": N_VIEWS, "atto180": N_VIEWS, "tiny720": HD_VIEWS}


def val_metrics(tcfg: TrainConfig, ckpt_dir: str, ds_root: str, val_split: str, mesh: Mesh) -> dict:
    """Per-object val predictions of the best checkpoint, their correlation
    with the labels and their spread (≙ exp_prvnet_r4.py:41-71)."""
    params, _ = load_checkpoint(os.path.join(ckpt_dir, "best_checkpoint.msgpack"))
    model = init_model(tcfg, len(PATTERN))
    _load_params(model, params)
    predict = make_eval_step(model, tcfg, mesh)
    ds = PVBDataset(ds_root, val_split, PATTERN, crop=tcfg.image_size)
    preds, gts = [], []
    for views, labels in ds.batches(tcfg.micro_batch):
        views, n_real = pad_to_multiple(views, mesh.size)
        preds.extend(predict(views)[:n_real].cpu().numpy().tolist())
        gts.extend(np.asarray(labels).tolist())
    preds, gts = np.asarray(preds), np.asarray(gts, dtype=np.float64)
    corr = float(np.corrcoef(preds, gts)[0, 1]) if preds.std() > 1e-9 and gts.std() > 1e-9 else 0.0
    return {
        "val_pred_gt_corr": corr,
        "val_pred_std": float(preds.std()),
        "val_gt_std": float(gts.std()),
        "val_pred_min_max": [float(preds.min()), float(preds.max())],
        "val_per_object": {n: {"pred": float(p), "gt": int(g)} for n, p, g in zip(ds.names, preds, gts)},
    }


def run_two_stage(ds_root: str, out_dir: str, seed: int = 0, pretrain_epochs: Optional[int] = None,
                  epochs: Optional[int] = None, mesh: Optional[Mesh] = None, device="cuda", log_every: int = 10,
                  regression_batch: Optional[int] = None, recipe: str = "tiny180") -> dict:
    """Pretrain then regression of ``recipe`` (a key of ``RECIPES``) on
    ``ds_root``'s splits at ``seed``, the checkpoints and logs under
    ``out_dir`` (``pretrain/``, ``regression/``); returns the reference's
    artifact fields.  The epochs default to the recipe's.  ``mesh``
    defaults to one device, ``device``; ``regression_batch`` cuts the
    regression's batch for a train split smaller than it (a rehearsal),
    its accumulation to the largest that divides it.  A finished seed leaves
    ``result.json`` and is not trained again; a cut one resumes from its
    best checkpoints, as the trainers do."""
    done = os.path.join(out_dir, "result.json")
    if os.path.exists(done):
        with open(done) as f:
            return json.load(f)
    if mesh is None:
        device = require_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = make_mesh(devices=[device])
    make_pre, make_reg, default_pre, default_epochs = RECIPES[recipe]
    pretrain_epochs = default_pre if pretrain_epochs is None else pretrain_epochs
    epochs = default_epochs if epochs is None else epochs
    train_split = os.path.join(ds_root, "train_split.txt")
    val_split = os.path.join(ds_root, "val_split.txt")
    pre_cfg = make_pre(seed, pretrain_epochs)
    pre_dir = os.path.join(out_dir, "pretrain")
    t0 = time.perf_counter()
    _, pre_best = pretrain(ds_root, train_split, val_split, cfg=pre_cfg, checkpoint_dir=pre_dir,
                           log_every=log_every, mesh=mesh, viewspace_size=VIEWSPACE[recipe])
    t_pre = time.perf_counter() - t0
    tcfg = make_reg(seed, epochs)
    if regression_batch is not None:
        tcfg = dataclasses.replace(tcfg, batch_size=regression_batch,
                                   accum_steps=math.gcd(regression_batch, tcfg.accum_steps))
    ckpt_dir = os.path.join(out_dir, "regression")
    t0 = time.perf_counter()
    _, best = train_regression(ds_root, train_split, val_split, cfg=tcfg, pattern=PATTERN,
                               checkpoint_dir=ckpt_dir, log_every=log_every, mesh=mesh,
                               premodel_file=os.path.join(pre_dir, "best_pretrain_checkpoint.msgpack"))
    t_train = time.perf_counter() - t0
    art = {
        "recipe": recipe, "arch": tcfg.arch, "seed": seed, "image_size": tcfg.image_size,
        "viewspace_size": VIEWSPACE[recipe], "batch_size": tcfg.batch_size, "accum_steps": tcfg.accum_steps,
        "pretrain_batch_size": pre_cfg.batch_size, "blr": tcfg.blr, "use_schedule": tcfg.use_schedule, "pretrain_blr": pre_cfg.blr,
        "pretrain_schedule": pre_cfg.use_schedule, "pretrain_warmup_epochs": pre_cfg.warmup_epochs,
        "n_train": len(read_split(train_split)), "n_val": len(read_split(val_split)),
        "pretrain_epochs": pretrain_epochs, "pretrain_best_l1": pre_best["l1_mean"], "pretrain_seconds": t_pre,
        "epochs": epochs, "best_val_accuracy": best["accuracy"], "best_val_l1_mean": best["l1_mean"],
        "best_val_l1_std": best["l1_std"], "train_seconds": t_train,
    }
    art.update(val_metrics(tcfg, ckpt_dir, ds_root, val_split, mesh))
    with open(os.path.join(ckpt_dir, "log.jsonl")) as f:
        art["val_l1_by_epoch"] = [json.loads(line)["l1_mean"] for line in f]
    with open(done, "w") as f:
        json.dump(art, f, indent=1)
    return art
