"""What the card checks share: where they write, the card line, a log
that goes to the terminal and a file, and a pool of worker processes."""

from __future__ import annotations

import json
import math
import multiprocessing
import os
import shutil
import subprocess
import time
from typing import Callable, Iterable, Iterator

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")
WORKSPACE = os.path.join(REPO, ".workspace")
LOG_DIR = os.path.join(REPO, "chiprun_out")
KERNELS = ("row_gather", "row_scatter_add", "splat", "voxel_cast")


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not measured"
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"


class Log:
    """Prints each line with the seconds since the start and appends it to
    ``path``."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.t0 = time.perf_counter()

    def __call__(self, *parts) -> None:
        line = f"[{time.perf_counter() - self.t0:8.1f} s] " + " ".join(str(p) for p in parts)
        print(line, flush=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")


def write_json(path: str, obj, copy_dir: str = None) -> None:
    """Write ``obj`` to ``path`` (atomically) and a copy into ``copy_dir``,
    which a run on another machine brings back."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    if copy_dir:
        os.makedirs(copy_dir, exist_ok=True)
        copy = os.path.join(copy_dir, os.path.basename(path))
        if os.path.abspath(copy) != os.path.abspath(path):
            shutil.copyfile(path, copy)


def restore_metrics(gt_path: str, fields: dict) -> None:
    """Write ``<count>.txt`` for each ``{count: {PSNR, SSIM, ...}}`` an
    earlier call recorded, where the file is missing: a call on another
    machine starts from an empty workspace, and mode 4 skips a count whose
    file exists."""
    from ..nerf.api import save_metrics

    for n, m in fields.items():
        path = os.path.join(gt_path, f"{n}.txt")
        if not os.path.exists(path):
            save_metrics(path, m)


def black_psnr(ds) -> float:
    """Mean per-frame PSNR of an all-black render against a test set (a
    loaded ``RayDataset`` or its transforms.json): the floor a trained
    field's PSNR is held above."""
    from ..nerf.rays import load_dataset

    ds = load_dataset(ds) if isinstance(ds, str) else ds
    gt = ds.pixels[..., :3] * ds.pixels[..., 3:4]
    return float(np.mean([-10.0 * math.log10(float(np.mean(f ** 2))) for f in gt]))


def build_kernels(device, names=KERNELS) -> None:
    """Build the path's kernels once, before any worker starts (each
    worker would otherwise compile its own copy)."""
    if str(device).startswith("cuda"):
        from ..ops import _build

        _build.build(names)


def run_jobs(fn: Callable, jobs: Iterable, workers: int) -> Iterator:
    """``fn`` over ``jobs``, results as they finish: in this process when
    ``workers <= 1``, else in that many spawned processes (the protocol's
    training is host-bound, so several share one card)."""
    jobs = list(jobs)
    if workers <= 1 or len(jobs) <= 1:
        for job in jobs:
            yield fn(job)
        return
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(workers, len(jobs))) as pool:
        yield from pool.imap_unordered(fn, jobs)
