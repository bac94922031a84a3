"""Fixtures of the benchmark's own tests (run with ``python -m pytest
portbench/tests``): the harness on ``sys.path``, cells cut to a size the CPU
runs in seconds, and the card fixture that skips where there is none."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

TINY_CAMERA = dict(width=64, height=36, fx=915.606689453125 / 20, fy=913.32666015625 / 20,
                   ppx=647.1453247070312 / 20, ppy=372.51531982421875 / 20)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def tiny(name: str, **traffic):
    """Cell ``name`` at a CPU size: a 12^3 voxel grid, a 2^12-entry hash table
    a level, 12 steps of 128 rays, 2 objects of 3 views at 64x36."""
    from lib import spec

    c = spec.cell(name)
    nerf = dict(c.config["nerf"], voxel_grid_size=12, train_rays=128, n_steps=12, train_warmup_steps=4,
                train_warmup_samples=8, n_samples=6, train_coarse=4, render_coarse=6, render_probe_fine=6,
                grid=dict(c.config["nerf"]["grid"], log2_table=12))
    tr = dict(c.traffic, objects=2, train_views=3, test_views=3, points=3000, camera=TINY_CAMERA)
    tr.update(traffic)
    return c._replace(config=dict(c.config, nerf=nerf), traffic=tr)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures only on the card")
    return torch.device("cuda", 0)
