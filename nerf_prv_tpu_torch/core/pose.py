"""Look-at camera pose solver with in-plane-roll selection.

Re-implements the semantics of ``View::get_next_camera_pos``
(``View_Space.hpp:67-197``) as *batched* numpy: the camera +Z axis points at
the object center and the roll about +Z is picked from 72 candidates (5°
steps) to either stay closest to the previous camera's orientation (mode 0)
or keep +Y pointing up (mode 1).  The whole candidate sweep is evaluated for
an entire batch of viewpoints at once instead of the reference's per-view
double loop.

Conventions (matching the reference):
- ``pose``      maps previous-camera-frame -> new-camera-frame (world -> camera
                when ``now_pose`` is identity, the pipeline's standing case).
- camera frame: +Z forward (toward object), OpenCV-style +Y down / +X right
                up to the selected roll.
"""

from __future__ import annotations

import numpy as np

_ANGLES_DEG = np.arange(5.0, 360.0, 5.0)  # candidate rolls beyond identity


def _normalize(v, axis=-1):
    return v / np.linalg.norm(v, axis=axis, keepdims=True)


def _base_frames(view_pos, center, now_pose):
    """Camera axes before roll selection (≙ View_Space.hpp:72-92)."""
    inv_now = np.linalg.inv(now_pose)
    view = view_pos @ inv_now[:3, :3].T + inv_now[:3, 3]
    obj = center @ inv_now[:3, :3].T + inv_now[:3, 3]
    z = _normalize(obj - view)
    x_raw = np.cross(z, view)
    # When the object center sits exactly on the view ray through the origin
    # (center == 0), Z x view degenerates; substitute the least-aligned basis
    # vector.  The reference avoids this only because centroids are merely
    # *near* zero (cf. the +1e-10 nudge in main.cpp:447).
    bad = np.linalg.norm(x_raw, axis=-1) < 1e-12
    if np.any(bad):
        basis = np.eye(3)
        alt = np.cross(z[bad], basis[np.argmin(np.abs(z[bad]), axis=-1)])
        x_raw = x_raw.copy()
        x_raw[bad] = alt
    x = _normalize(x_raw)
    y = _normalize(np.cross(z, x))
    n = view.shape[0]
    rot = np.zeros((n, 4, 4))
    rot[:, 3, 3] = 1.0
    rot[:, :3, 0] = x
    rot[:, :3, 1] = y
    rot[:, :3, 2] = z
    trans = np.tile(np.eye(4), (n, 1, 1))
    trans[:, :3, 3] = -view
    return rot, trans


def _rz(angle_rad: float) -> np.ndarray:
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    m = np.eye(4)
    m[0, 0] = c
    m[0, 1] = -s
    m[1, 0] = s
    m[1, 1] = c
    return m


def look_at_poses(view_pos, center, now_pose=None, mode: int = 0) -> np.ndarray:
    """Batched pose solve; returns (N, 4, 4) ``pose`` matrices.

    ``view_pos``: (N, 3) candidate camera positions (world frame).
    ``center``:   (3,) object center.
    ``mode`` 0: minimize in-plane rotation relative to ``now_pose``
    (≙ View_Space.hpp:93-139); mode 1: keep +Y up (≙ 141-193).
    """
    view_pos = np.atleast_2d(np.asarray(view_pos, dtype=np.float64))
    center = np.asarray(center, dtype=np.float64)
    now_pose = np.eye(4) if now_pose is None else np.asarray(now_pose, dtype=np.float64)
    rot, trans = _base_frames(view_pos, np.broadcast_to(center, view_pos.shape), now_pose)
    n = view_pos.shape[0]

    y_h = np.array([0.0, 1.0, 0.0, 1.0])
    x_h = np.array([1.0, 0.0, 0.0, 1.0])

    def rays(rz):
        m = np.linalg.inv(rot @ rz) @ trans
        return m @ x_h, m @ y_h

    best_rz = np.tile(np.eye(4), (n, 1, 1))
    if mode == 0:
        with np.errstate(invalid="ignore"):
            x_ray, y_ray = rays(np.eye(4))
            # NaN outside [-1,1] matches C's acos; NaN comparisons stay False,
            # reproducing the reference's candidate-rejection behavior.
            min_y = np.arccos(y_ray[:, 1])
            min_x = np.arccos(x_ray[:, 0])
            for ang in _ANGLES_DEG:
                rz = _rz(np.deg2rad(ang))
                x_ray, y_ray = rays(rz)
                cos_y = np.arccos(y_ray[:, 1])
                cos_x = np.arccos(x_ray[:, 0])
                better = cos_y < min_y
                tie = (np.abs(cos_y - min_y) < 1e-6) & (cos_x < min_x)
                take = better | tie
                best_rz[take] = rz
                min_y = np.where(take, cos_y, min_y)
                min_x = np.where(take, cos_x, min_x)
    elif mode == 1:
        y0 = (now_pose @ (rot @ np.eye(4) @ trans) @ y_h.reshape(4, 1)).squeeze(-1)
        best = y0[:, 2]
        for ang in _ANGLES_DEG:
            rz = _rz(np.deg2rad(ang))
            y_now = (now_pose @ (rot @ rz @ trans) @ y_h.reshape(4, 1)).squeeze(-1)
            take = y_now[:, 2] > best
            best_rz[take] = rz
            best = np.where(take, y_now[:, 2], best)
    else:
        raise ValueError(f"unknown pose mode {mode}")

    return np.linalg.inv(rot @ best_rz) @ trans


def camera_to_world(view_pos, center, now_pose=None, mode: int = 0) -> np.ndarray:
    """World-frame camera-to-world matrices (N, 4, 4).

    ≙ ``now_camera_pose_world * view.pose.inverse()`` (``main.cpp:1627``).
    """
    now_pose = np.eye(4) if now_pose is None else np.asarray(now_pose, dtype=np.float64)
    poses = look_at_poses(view_pos, center, now_pose, mode)
    return now_pose @ np.linalg.inv(poses)
