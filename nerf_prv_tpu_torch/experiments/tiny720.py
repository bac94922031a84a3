"""PRVNet at the reference's configuration, one training step on the card.

    python -m nerf_prv_tpu_torch.experiments.tiny720 [--device cuda]

Counterpart of ``experiments/exp_tiny720.py``: ConvNeXt-V2 tiny at
CenterCrop 720, five views an object (``IMG_PATTERN[4]``), one optimizer
application of the whole batch on random pixels.  Batch 64 is tried first
and halved while the card runs out of memory (``torch.OutOfMemoryError``;
any other error stops the run).  At the batch that fits, a first step (the
warm-up: cuDNN's choice of algorithms, the allocator's first blocks), then
the median of 4 steps, each ended by reading the loss back.  Reported: the
parameters in millions, the step's seconds, images/s, objects/s, the peak
memory, and the epoch walls this rate gives for the reference's
~3,000-object dataset and a 120-object one (gradient accumulation makes up
batch 64 from the micro-batch that fits).  The result, with the card's
name and power limit, goes to
``nerf_prv_tpu_torch/experiments/results/tiny720.json``.
"""

from __future__ import annotations

import argparse
import gc
import os
import time

import numpy as np
import torch

from .label_protocol import require_device
from .runs import LOG_DIR, RESULTS_DIR, card_line, write_json

ARCH = "convnextv2_tiny"
N_VIEWS = 5  # IMG_PATTERN[4]
CROP = 720
FIRST_BATCH = 64
TIMED_STEPS = 4
EPOCH_OBJECTS = (3000, 120)


def measure(batch_size: int, device) -> dict:
    """One tiny@720 training step of ``batch_size`` objects on ``device``:
    the warm-up step's seconds, then the median of ``TIMED_STEPS``."""
    from ..parallel.mesh import make_mesh
    from ..prvnet.train import TrainConfig, init_model, make_train_step

    cfg = TrainConfig(arch=ARCH, batch_size=batch_size, image_size=CROP)
    model = init_model(cfg, N_VIEWS).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(model, cfg, mesh=make_mesh(devices=[device]))
    gen = torch.Generator(device=device).manual_seed(0)
    views = torch.rand((batch_size, N_VIEWS, CROP, CROP, 3), generator=gen, device=device)
    labels = 13.0 + 45.0 * torch.rand((batch_size,), generator=gen, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    float(step(views, labels))
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        float(step(views, labels))
        times.append(time.perf_counter() - t0)
    step_s = float(np.median(times))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {
        "batch_size": batch_size,
        "n_params_m": n_params / 1e6,
        "warm_step_seconds": warm_s,
        "step_seconds": step_s,
        "step_seconds_all": times,
        "images_per_second": batch_size * N_VIEWS / step_s,
        "objects_per_second": batch_size / step_s,
        "peak_memory_gb": None if peak is None else peak / 1e9,
    }


def run(device) -> dict:
    """:func:`measure` from ``FIRST_BATCH``, halved after each out-of-memory
    error; the attempts and, at the batch that fits, the epoch walls."""
    result = {"arch": ARCH, "image_size": CROP, "n_views": N_VIEWS, "attempts": []}
    got, bs = None, FIRST_BATCH
    while bs >= 1 and got is None:
        print(f"trying batch {bs}...", flush=True)
        try:
            got = measure(bs, device)
        except torch.OutOfMemoryError as e:
            result["attempts"].append({"batch_size": bs, "error": str(e).splitlines()[0][:200]})
        if got is None:
            print(f"batch {bs}: out of memory", flush=True)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            bs //= 2
    if got is None:
        raise SystemExit(f"tiny@720: not even one object a step fits on {device}")
    result["attempts"].append(got)
    result["batch_held"] = got["batch_size"]
    for n in EPOCH_OBJECTS:
        result[f"epoch_seconds_{n}_objects"] = n / got["objects_per_second"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "tiny720.json"))
    args = ap.parse_args(argv)
    device = require_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    result = dict(card=card_line(), **run(device))
    write_json(args.out, result, LOG_DIR)
    print(f"tiny@720 on {result['card']}: batch {result['batch_held']}, "
          f"{result['attempts'][-1]['images_per_second']:.1f} images/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
