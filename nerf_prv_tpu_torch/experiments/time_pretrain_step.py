"""Time the tiny@180 pretrain step on the card: one training alone, then two
and three trainings at once, each in a thread of its own on a CUDA stream
of its own, so their kernels may overlap.

    python -m nerf_prv_tpu_torch.experiments.time_pretrain_step

Prints, for each count of trainings, the wall of 12 AdamW applications each
(64 images at 180x180, random pixels) after 3 to warm up, the time an
application, and the peak memory.  If the card were not full with one
training, several at once would take less time an application.
"""

from __future__ import annotations

import threading
import time

import torch

from ..parallel.mesh import make_mesh
from ..prvnet.model import make_pvbpretrain
from ..prvnet.train import _init_like_flax, make_train_step
from .prvnet_recipe import pretrain_config

APPLICATIONS = 12
WARMUP = 3


def _applications(step, n: int, done: dict, key: int, stream, dev) -> None:
    with torch.cuda.stream(stream):
        g = torch.Generator(device=dev).manual_seed(key)
        x = torch.rand((64, 180, 180, 3), generator=g, device=dev)
        y = torch.full((64,), 30.0, device=dev)
        for _ in range(n):
            step.sharded([(x, y)])
        stream.synchronize()
        done[key] = time.perf_counter()


def _at_once(steps, streams, n: int, dev) -> float:
    """Wall from the start until the last of ``steps`` has run ``n``
    applications, each in its own thread."""
    done = {}
    threads = [threading.Thread(target=_applications, args=(s, n, done, i, st, dev))
               for i, (s, st) in enumerate(zip(steps, streams))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return max(done.values()) - t0


def main() -> None:
    # the trainer scopes its float32 convolutions per step; with several
    # threads entering and leaving that scope the global must already agree
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_mesh(devices=[dev])
    cfg = pretrain_config()
    for k in (1, 2, 3, 1):
        steps = []
        for seed in range(k):
            model = make_pvbpretrain(cfg.arch)
            _init_like_flax(model, torch.Generator().manual_seed(seed))
            steps.append(make_train_step(model, cfg, None, mesh))
        streams = [torch.cuda.Stream() for _ in range(k)]
        _at_once(steps, streams, WARMUP, dev)
        wall = _at_once(steps, streams, APPLICATIONS, dev)
        print(f"{k} trainings at once: {wall:.2f} s for {k * APPLICATIONS} applications, "
              f"{wall / (k * APPLICATIONS):.4f} s an application, "
              f"peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB", flush=True)
        del steps
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
