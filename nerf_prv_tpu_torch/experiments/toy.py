"""The ``toy0`` object of the end-to-end experiments.

The port's copy of ``tests/synthetic.py::make_object`` (numpy only) and of
the ``toy0`` PLY writer that ``experiments/exp_e2e_mode21.py:26-29`` and
``experiments/exp_warmstart.py:45-48`` share: ``make_object(30000, seed=3)``
scaled by 20 and written with ``save_ply_binary`` under
``<root>/models/ShapeNet/toy0.ply``.  The arrays and the file's bytes equal
the JAX side's.
"""

from __future__ import annotations

import os

import numpy as np

from ..scene.ply import save_ply_binary

TOY_NAME = "toy0"
TOY_POINTS = 30000
TOY_SEED = 3
TOY_SCALE = 20


def make_object(n: int = 20000, seed: int = 0, size: float = 0.05):
    """A dense coloured ball-ish blob with position-dependent colours:
    (n, 3) float64 points and (n, 3) uint8 colours."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3))
    pts = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= size * rng.uniform(0.7, 1.0, size=(n, 1))
    cols = np.clip(((pts / size) * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    return pts, cols


def toy_ply_path(root: str) -> str:
    return os.path.join(root, "models", "ShapeNet", f"{TOY_NAME}.ply")


def write_toy(root: str) -> str:
    """Write ``toy0.ply`` under ``root`` where it is missing; returns its path."""
    ply = toy_ply_path(root)
    if not os.path.exists(ply):
        pts, cols = make_object(TOY_POINTS, seed=TOY_SEED)
        save_ply_binary(ply, pts * TOY_SCALE, cols)
    return ply
