"""Local collision-free path geometry around a spherical obstacle.

Counterpart of ``nerf_prv_tpu/planning/local_path.py``.  It re-implements
the semantics of ``get_local_path`` / ``get_trajectory_xyz``
(``View_Space.hpp:206-490``): the shortest path between two viewpoints that
avoids a sphere (the object's bounding sphere) is either the straight segment
or a line–arc–line detour through the tangent circle in the plane of the two
intersection points.

Two implementations:
- scalar numpy (`local_path`, `trajectory`) for planner bookkeeping, and
- a batched torch computation (`pairwise_lengths`) that builds an entire
  TSP edge matrix on the device in float32, as the reference's jitted
  version does, instead of the reference's O(n^2) scalar loop
  (``main.cpp:434-455``).

The arc length uses the unambiguous central angle acos((P-O)·(Q-O)/r^2)
(the minor arc) rather than the reference's branch-disambiguated theta
parametrization — identical on all non-degenerate inputs.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

ERROR_PATH = -2
WRONG_PATH = -1
LINE_PATH = 0
CIRCLE_PATH = 1

_BIG = 1e10


def _segment_sphere_params(m, n, o, r):
    d = n - m
    f = m - o
    a = float(d @ d)
    b = 2.0 * float(d @ f)
    c = float(f @ f) - r * r
    delta = b * b - 4.0 * a * c
    return a, b, c, delta


def local_path(m, n, o, r) -> Tuple[int, float]:
    """(mode, length) of the shortest obstacle-avoiding path M -> N.

    ≙ ``get_local_path`` (``View_Space.hpp:206-305``).
    """
    m = np.asarray(m, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    o = np.asarray(o, dtype=np.float64)
    a, b, c, delta = _segment_sphere_params(m, n, o, r)
    if delta <= 0:
        return LINE_PATH, float(np.linalg.norm(n - m))
    sq = np.sqrt(delta)
    t3 = (-b - sq) / (2.0 * a)
    t4 = (-b + sq) / (2.0 * a)
    in3 = 0.0 <= t3 <= 1.0
    in4 = 0.0 <= t4 <= 1.0
    if not in3 and not in4:
        return LINE_PATH, float(np.linalg.norm(n - m))
    if in3 != in4:
        # one endpoint is inside the obstacle (≙ View_Space.hpp:233-236)
        return WRONG_PATH, _BIG
    if t3 > t4:
        t3, t4 = t4, t3
    p = m + (n - m) * t3
    q = m + (n - m) * t4
    cosang = np.clip((p - o) @ (q - o) / (r * r), -1.0, 1.0)
    arc = np.arccos(cosang) * r
    length = float(np.linalg.norm(p - m) + arc + np.linalg.norm(n - q))
    return CIRCLE_PATH, length


def _rotate_about_axis(v, axis, angle):
    """Rodrigues rotation (numpy)."""
    axis = axis / np.linalg.norm(axis)
    return (
        v * np.cos(angle)
        + np.cross(axis, v) * np.sin(angle)
        + axis * (axis @ v) * (1.0 - np.cos(angle))
    )


def trajectory(
    m,
    n,
    o,
    predicted_size: float,
    dist_per_move: float,
    camera_to_object_dis: float = 0.0,
    min_z: float = 0.05,
) -> Tuple[int, List[np.ndarray]]:
    """Waypoint sampler (≙ ``get_trajectory_xyz``, ``View_Space.hpp:307-490``).

    Returns (num_waypoints, waypoints); num = -1 when an endpoint is inside
    the obstacle, -2 when the path is a straight line (matching the
    reference's return codes).  If the minor arc dips below ``min_z`` the
    detour flips to the major arc on the other side (≙ lines 448-487).
    """
    m = np.asarray(m, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    o = np.asarray(o, dtype=np.float64)
    r = predicted_size + camera_to_object_dis
    a, b, c, delta = _segment_sphere_params(m, n, o, r)

    def line_points():
        d = float(np.linalg.norm(n - m))
        num = int(d / dist_per_move) + 1
        ts = np.arange(1, num + 1) / num
        return num, [m + (n - m) * t for t in ts]

    if delta <= 0:
        _, pts = line_points()
        return -2, pts
    sq = np.sqrt(delta)
    t3 = (-b - sq) / (2.0 * a)
    t4 = (-b + sq) / (2.0 * a)
    in3 = 0.0 <= t3 <= 1.0
    in4 = 0.0 <= t4 <= 1.0
    if not in3 and not in4:
        return line_points()
    if in3 != in4:
        return -1, []
    if t3 > t4:
        t3, t4 = t4, t3
    p = m + (n - m) * t3
    q = m + (n - m) * t4
    u = p - o
    v = q - o
    phi = float(np.arccos(np.clip(u @ v / (r * r), -1.0, 1.0)))
    axis = np.cross(u, v)
    if np.linalg.norm(axis) < 1e-12:
        return line_points()

    def sample(arc_angle: float, direction: float):
        mp = float(np.linalg.norm(p - m))
        qn = float(np.linalg.norm(n - q))
        arc_len = abs(arc_angle) * r
        d = mp + arc_len + qn
        num = int(d / dist_per_move) + 1
        step = d / num
        pts = []
        ok = True
        for i in range(1, num + 1):
            di = step * i
            if di <= mp:
                pt = m + (p - m) * (di / mp if mp > 0 else 0.0)
            elif di >= mp + arc_len:
                t = (di - mp - arc_len) / qn if qn > 0 else 1.0
                pt = q + (n - q) * t
            else:
                ang = direction * (di - mp) / r
                pt = o + _rotate_about_axis(u, axis, ang)
                if pt[2] < min_z:
                    ok = False
                    break
            pts.append(pt)
        return ok, num, pts

    ok, num, pts = sample(phi, 1.0)
    if not ok:
        # go the long way around, ignoring the height check (≙ lines 457-487)
        _, num, pts = sample(2.0 * np.pi - phi, -1.0)
        pts = [pt for pt in pts]
    return num, pts


# --------------------------------------------------------------------------
# Batched pairwise edge lengths (TSP graph construction)
# --------------------------------------------------------------------------


def pairwise_lengths(views, center, radius, device="cuda") -> torch.Tensor:
    """(n, n) float32 local-path length matrix for the whole view set, on
    ``device``: the straight length where the segment clears the sphere,
    ``_BIG`` where one endpoint lies inside it, else the line-arc-line
    detour (the classes of :func:`local_path`).

    Replaces the reference's per-pair scalar graph fill (``main.cpp:434-455``)
    with one batched computation.
    """
    views = torch.as_tensor(np.asarray(views, np.float32), device=device)
    center = torch.as_tensor(np.asarray(center, np.float32), device=device)
    # a float32 scalar, so that radius^2 rounds as the reference's does
    radius = torch.tensor(radius, dtype=torch.float32, device=device)
    m = views[:, None, :]
    n = views[None, :, :]
    d = n - m
    f = m - center
    a = torch.sum(d * d, dim=-1)
    b = 2.0 * torch.sum(d * f, dim=-1)
    c = torch.sum(f * f, dim=-1) - radius * radius
    delta = b * b - 4.0 * a * c
    a_safe = torch.where(a > 0, a, 1.0)
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    t3 = (-b - sq) / (2.0 * a_safe)
    t4 = (-b + sq) / (2.0 * a_safe)
    in3 = (t3 >= 0.0) & (t3 <= 1.0)
    in4 = (t4 >= 0.0) & (t4 <= 1.0)
    straight = torch.linalg.vector_norm(d, dim=-1)

    p = m + d * t3[..., None]
    q = m + d * t4[..., None]
    cosang = torch.clamp(
        torch.sum((p - center) * (q - center), dim=-1) / (radius * radius), -1.0, 1.0
    )
    arc = torch.arccos(cosang) * radius
    detour = (
        torch.linalg.vector_norm(p - m, dim=-1) + arc + torch.linalg.vector_norm(n - q, dim=-1)
    )

    is_line = (delta <= 0.0) | (~in3 & ~in4)
    is_wrong = in3 ^ in4
    return torch.where(is_line, straight, torch.where(is_wrong, _BIG, detour))
