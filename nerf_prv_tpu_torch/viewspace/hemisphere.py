"""Hemisphere view-space generation and IO.

The port of ``nerf_prv_tpu/viewspace/hemisphere.py``: N points on the upper
hemisphere with one pinned to the +z pole (the pipeline's start view),
packed by Riesz-energy gradient descent, every restart one row of a single
batched tensor program on the device.  The files stay byte-compatible with
the shipped ``Hemisphere/N.txt`` (N rows of ``x y z``,
``Share_Data.hpp:517-526``).

The reference draws its start points with ``jax.random``; the port draws
them with a ``torch.Generator``, so one seed gives other (equally packed)
view spaces.  :func:`_optimize_one` takes the start points, so that a test
can hand it the reference's.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def load_view_space(viewspace_dir: str, n: int) -> np.ndarray:
    """Read ``<dir>/<n>.txt`` -> (n, 3) float64 (≙ Share_Data.hpp:517-526)."""
    path = os.path.join(viewspace_dir, f"{n}.txt")
    pts = np.loadtxt(path, dtype=np.float64)
    pts = np.atleast_2d(pts)
    if pts.shape != (n, 3):
        raise ValueError(f"{path}: expected {(n, 3)}, got {pts.shape}")
    return pts


def save_view_space(viewspace_dir: str, pts: np.ndarray) -> str:
    os.makedirs(viewspace_dir, exist_ok=True)
    path = os.path.join(viewspace_dir, f"{len(pts)}.txt")
    with open(path, "w") as f:
        for p in pts:
            f.write(f"{p[0]:.8g} {p[1]:.8g} {p[2]:.8g}\n")
    return path


def load_path_order(viewspace_dir: str, n: int) -> np.ndarray:
    """Read ``<dir>/<n>_path.txt`` -> (n,) int visit order, start view first."""
    path = os.path.join(viewspace_dir, f"{n}_path.txt")
    return np.loadtxt(path, dtype=np.int64).reshape(-1)


def save_path_order(viewspace_dir: str, order: np.ndarray) -> str:
    os.makedirs(viewspace_dir, exist_ok=True)
    path = os.path.join(viewspace_dir, f"{len(order)}_path.txt")
    with open(path, "w") as f:
        for i in order:
            f.write(f"{int(i)}\n")
    return path


# --------------------------------------------------------------------------
# Hemisphere packing by Riesz-energy descent, restarts batched
# --------------------------------------------------------------------------


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _hemisphere_project(pts: torch.Tensor) -> torch.Tensor:
    """Project (R, n, 3) onto the unit upper hemisphere, pole pinned at row 0."""
    pts = torch.cat([pts[..., :2], pts[..., 2:].abs()], dim=-1)
    pts = pts / _norm(pts)
    pts[:, 0] = torch.tensor([0.0, 0.0, 1.0], dtype=pts.dtype, device=pts.device)
    return pts


def _pair_d2(pts: torch.Tensor):
    """(differences (R, n, n, 3), squared distances (R, n, n))."""
    diff = pts[:, :, None, :] - pts[:, None, :, :]
    return diff, (diff * diff).sum(-1)


def _riesz_energy(pts: torch.Tensor) -> torch.Tensor:
    """(R,) Riesz s=2 energy of each restart's (n, 3) points."""
    _, d2 = _pair_d2(pts)
    n = pts.shape[1]
    mask = 1.0 - torch.eye(n, dtype=pts.dtype, device=pts.device)
    return 0.5 * (mask / torch.clamp(d2, min=1e-12)).sum(dim=(1, 2))


def _riesz_grad(pts: torch.Tensor) -> torch.Tensor:
    """d energy / d pts in closed form: -2 sum_j (p_i - p_j) / d2_ij^2 over
    j != i; a pair closer than 1e-6 adds nothing, as the clamp's gradient
    is zero there in the reference's autodiff."""
    diff, d2 = _pair_d2(pts)
    n = pts.shape[1]
    keep = (d2 > 1e-12) & ~torch.eye(n, dtype=torch.bool, device=pts.device)
    w = torch.where(keep, -2.0 / (d2 * d2).clamp(min=1e-24), torch.zeros_like(d2))
    return (w[..., None] * diff).sum(dim=2)


def _optimize_one(pts0: torch.Tensor, steps: int = 800, lr: float = 3e-3):
    """Descend each restart's start points ``pts0`` (R, n, 3) (raw normal
    draws; z is set to 0.5 first, as the reference does with its
    ``jax.random.normal`` draw, ``hemisphere.py:83``).  Returns
    (points (R, n, 3), energy (R,))."""
    pts = pts0.to(torch.float32).clone()
    pts[..., 2] = 0.5
    pts = _hemisphere_project(pts)
    for i in range(steps):
        g = _riesz_grad(pts)
        # tangent-plane projection keeps the update on the sphere manifold
        g = g - (g * pts).sum(-1, keepdim=True) * pts
        g = g / torch.clamp(_norm(g), min=1.0)  # clip exploding near-collision grads
        # the reference's f32 schedule: lr * (1 - 0.9 * i / steps)
        f32 = np.float32
        decay = f32(lr) * (f32(1.0) - f32(0.9) * f32(i) / f32(steps))
        pts = _hemisphere_project(pts - float(decay) * g)
    return pts, _riesz_energy(pts)


def generate_hemisphere(n: int, seed: int = 0, restarts: int = 8, steps: int = 800,
                        device="cuda") -> np.ndarray:
    """Optimize an n-point hemisphere view space; returns (n, 3) unit vectors
    with point (0,0,1) included (the NBV loop's start view)."""
    if n < 1:
        raise ValueError("n must be >= 1")
    if n == 1:
        return np.array([[0.0, 0.0, 1.0]])
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    pts0 = torch.randn((restarts, n, 3), generator=g, device=device)
    pts, energy = _optimize_one(pts0, steps)
    best = int(torch.argmin(energy))
    return pts[best].cpu().numpy().astype(np.float64)


def min_pairwise_angle(pts: np.ndarray) -> float:
    """Packing quality: smallest pairwise central angle (radians)."""
    pts = np.asarray(pts)
    cos = np.clip(pts @ pts.T, -1.0, 1.0)
    np.fill_diagonal(cos, -1.0)
    return float(np.arccos(cos.max()))


def sum_pairwise_distance(pts: np.ndarray) -> float:
    """The reference's dispersion metric (≙ main.cpp:1164-1169)."""
    pts = np.asarray(pts)
    diff = pts[:, None, :] - pts[None, :, :]
    d = np.sqrt((diff**2).sum(-1))
    return float(np.triu(d, 1).sum())


def generate_all(
    viewspace_dir: str, sizes=range(3, 101), seed: int = 0, improve: bool = False, device="cuda"
) -> None:
    """Mode-0 equivalent: write ``N.txt`` for every requested size
    (≙ main.cpp:1147-1177).

    Existing files are skipped by default; ``improve=True`` regenerates and
    keeps whichever of old/new has the higher dispersion.
    """
    for n in sizes:
        path = os.path.join(viewspace_dir, f"{n}.txt")
        if os.path.exists(path) and not improve:
            continue
        pts = generate_hemisphere(n, seed=seed + n, device=device)
        if os.path.exists(path):
            old = load_view_space(viewspace_dir, n)
            if sum_pairwise_distance(old) >= sum_pairwise_distance(pts):
                continue
        save_view_space(viewspace_dir, pts)


class ViewSpace:
    """Candidate views placed around an object (≙ ``View_Space``,
    ``View_Space.hpp:492-728``): center = point centroid, bounding radius =
    max distance x 17/16, each z>=0 unit direction placed at
    ``view_space_radius`` from the center.  Host-side float64, as in the
    reference."""

    def __init__(self, unit_views: np.ndarray, object_points: np.ndarray, radius: float):
        unit_views = np.asarray(unit_views, dtype=np.float64)
        pts = np.asarray(object_points, dtype=np.float64)
        self.object_center = pts.mean(axis=0)
        self.predicted_size = float(
            np.linalg.norm(pts - self.object_center, axis=1).max() * 17.0 / 16.0
        )
        keep = unit_views[:, 2] >= 0  # ≙ View_Space.hpp:551
        pt_norm = np.linalg.norm(unit_views[0])  # ≙ Share_Data.hpp pt_norm
        scale = radius / pt_norm  # ≙ View_Space.hpp:552
        self.views = unit_views[keep] * scale + self.object_center
        self.radius = radius

    def __len__(self) -> int:
        return len(self.views)

    def top_view_id(self, radius: Optional[float] = None) -> int:
        """Index of the (0, 0, r) start view (≙ main.cpp:2211-2219)."""
        r = self.radius if radius is None else radius
        target = self.object_center + np.array([0.0, 0.0, r])
        d = np.linalg.norm(self.views - target, axis=1)
        i = int(np.argmin(d))
        if d[i] > 1e-5:
            raise ValueError("view space has no (0,0,r) start view")
        return i
