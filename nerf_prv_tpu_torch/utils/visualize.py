"""Offline debug visualization — the ``show``-flag equivalent.

Counterpart of ``nerf_prv_tpu/utils/visualize.py`` (numpy and PIL only,
copied; the local path and the PLY writer are the port's).

The reference's main debugging tool is interactive PCL viewers of view
spaces, clouds, and planned trajectories (``View_Space.hpp:575-689``,
``main.cpp:3754-3823``, gated by the global ``show`` flag).  A headless
pipeline can't pop windows, so the same inspectables are exported as files:

- :func:`export_view_space_ply` — view positions (+ optional object cloud)
  as a colored PLY anyone can open in MeshLab/CloudCompare;
- :func:`export_trajectory_ply` — the planned line-arc trajectory densely
  sampled into a polyline point cloud (≙ the waypoint spheres the
  reference draws at ``main.cpp:3785-3820``);
- :func:`plot_view_space_png` — a dependency-light PIL rendering (top-down
  + side orthographic projections) of views, visit order, and trajectory.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

_VIEW_COLOR = (30, 100, 255)      # views: blue (≙ the reference's blue spheres)
_START_COLOR = (255, 80, 30)      # start view highlighted
_TRAJ_COLOR = (30, 200, 80)       # trajectory: green
_OBJECT_COLOR = (160, 160, 160)   # object cloud: gray fallback


def export_view_space_ply(
    path: str,
    views: np.ndarray,
    object_points: Optional[np.ndarray] = None,
    object_colors: Optional[np.ndarray] = None,
    start_id: Optional[int] = None,
) -> None:
    """Write views (N, 3) [+ object cloud] as one colored ascii PLY."""
    from ..scene.ply import save_ply_ascii

    views = np.asarray(views, np.float64).reshape(-1, 3)
    cols = np.tile(np.array(_VIEW_COLOR, np.uint8), (len(views), 1))
    if start_id is not None:
        cols[int(start_id)] = _START_COLOR
    pts = views
    if object_points is not None:
        object_points = np.asarray(object_points, np.float64).reshape(-1, 3)
        oc = (
            np.asarray(object_colors, np.uint8).reshape(-1, 3)
            if object_colors is not None
            else np.tile(np.array(_OBJECT_COLOR, np.uint8), (len(object_points), 1))
        )
        pts = np.concatenate([pts, object_points])
        cols = np.concatenate([cols, oc])
    save_ply_ascii(path, pts, cols)


def trajectory_polyline(
    views: np.ndarray,
    order: Sequence[int],
    object_center: np.ndarray,
    predicted_size: float,
    points_per_leg: int = 40,
) -> np.ndarray:
    """Densely sampled line-arc trajectory through ``order`` (~M*legs, 3)
    (≙ get_trajectory_xyz waypoints, View_Space.hpp:307-490).  Legs whose
    endpoint sits inside the obstacle (trajectory code -1) fall back to the
    straight segment so the export always shows the full visit order."""
    from ..planning.local_path import trajectory

    views = np.asarray(views, np.float64)
    legs = []
    for a, b in zip(order[:-1], order[1:]):
        leg_len = float(np.linalg.norm(views[b] - views[a]))
        step = max(leg_len / points_per_leg, 1e-9)
        num, pts = trajectory(
            views[a], views[b], object_center, predicted_size, dist_per_move=step
        )
        if num == -1 or not pts:
            pts = [views[a], views[b]]
        legs.append(np.concatenate([views[a][None], np.asarray(pts).reshape(-1, 3)]))
    return np.concatenate(legs) if legs else np.zeros((0, 3))


def export_trajectory_ply(
    path: str,
    views: np.ndarray,
    order: Sequence[int],
    object_center: np.ndarray,
    predicted_size: float,
    points_per_leg: int = 40,
) -> np.ndarray:
    """Write the planned trajectory as a green polyline point cloud; view
    positions are appended in blue.  Returns the sampled polyline."""
    from ..scene.ply import save_ply_ascii

    poly = trajectory_polyline(
        views, order, object_center, predicted_size, points_per_leg
    )
    views = np.asarray(views, np.float64).reshape(-1, 3)
    pts = np.concatenate([poly, views])
    cols = np.concatenate(
        [
            np.tile(np.array(_TRAJ_COLOR, np.uint8), (len(poly), 1)),
            np.tile(np.array(_VIEW_COLOR, np.uint8), (len(views), 1)),
        ]
    )
    save_ply_ascii(path, pts, cols)
    return poly


def plot_view_space_png(
    path: str,
    views: np.ndarray,
    order: Optional[Sequence[int]] = None,
    trajectory_points: Optional[np.ndarray] = None,
    size: int = 480,
) -> None:
    """Render top-down (x/y) and side (x/z) orthographic projections of the
    view space — views as dots, visit order as connecting segments, the
    sampled trajectory as a green polyline — into one PNG."""
    from PIL import Image, ImageDraw

    views = np.asarray(views, np.float64).reshape(-1, 3)
    all_pts = views
    if trajectory_points is not None and len(trajectory_points):
        all_pts = np.concatenate([views, np.asarray(trajectory_points)])
    lo = all_pts.min(axis=0)
    hi = all_pts.max(axis=0)
    span = float(max(hi.max() - lo.min(), 1e-9))
    margin = 24

    def proj(p, axes):
        u = (p[..., axes[0]] - lo[axes[0]]) / span
        v = (p[..., axes[1]] - lo[axes[1]]) / span
        x = margin + u * (size - 2 * margin)
        y = size - margin - v * (size - 2 * margin)
        return np.stack([x, y], axis=-1)

    img = Image.new("RGB", (2 * size, size), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    for pane, axes, label in ((0, (0, 1), "top (x,y)"), (1, (0, 2), "side (x,z)")):
        off = pane * size
        draw.text((off + 8, 6), label, fill=(0, 0, 0))
        if trajectory_points is not None and len(trajectory_points):
            tp = proj(np.asarray(trajectory_points), axes)
            draw.line(
                [(off + float(x), float(y)) for x, y in tp],
                fill=_TRAJ_COLOR,
                width=1,
            )
        pv = proj(views, axes)
        if order is not None:
            seq = [(off + float(pv[i, 0]), float(pv[i, 1])) for i in order]
            draw.line(seq, fill=(200, 160, 40), width=1)
        for i, (x, y) in enumerate(pv):
            color = _START_COLOR if (order is not None and i == order[0]) else _VIEW_COLOR
            r = 4 if (order is not None and i == order[0]) else 3
            draw.ellipse(
                (off + x - r, y - r, off + x + r, y + r), fill=color
            )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    img.save(path)
