"""Object preparation: load, orient, center, size-augment, voxelize.

Equivalent of ``NBV_Net_Labeler``'s constructor (``main.cpp:630-1115``):
loads a colored point cloud, applies the toward/rotate orientation states,
recenters at the origin, runs the ShapeNet random-size augmentation loop
(rendered object-pixel-rate acceptance, ``main.cpp:851-964``), derives the
dynamic voxel resolution, and builds the ground-truth voxel scene plus the
candidate view space.

The port of ``nerf_prv_tpu/scene/object_setup.py``.  Host-side numpy as
there, with the numpy RNG of the size augmentation drawn in the same order
(the same sizes for the same seed); the five size-test renders of each try
are one K8 launch and the voxel grids live on ``device``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.config import Config
from ..core.pose import camera_to_world
from ..viewspace.hemisphere import ViewSpace, generate_hemisphere, load_view_space, save_view_space
from .ply import load_ply
from .render import object_pixel_rate, render_pointcloud_views
from .voxel import GTSampleGrid, VoxelScene, make_gt_sample

# Per-object size shrink overrides for the large scanned models
# (≙ Share_Data::mp_scale, Share_Data.hpp:420-450)
MP_SCALE = {
    "Armadillo": 0.02,
    "Asian_Dragon": 0.05,
    "Dragon": 0.05,
    "Stanford_Bunny": 0.04,
    "Happy_Buddha": 0.07,
    "Thai_Statue": 0.25,
    "Lucy": 1.39,
    "LM1": 0.03,
    "LM2": 0.03,
    "LM3": 0.03,
    "LM4": 0.03,
    "LM5": 0.03,
    "LM6": 0.03,
    "LM7": 0.03,
    "LM8": 0.03,
    "LM9": 0.03,
    "LM10": 0.03,
    "LM11": 0.03,
    "LM12": 0.03,
    "obj_000001": 0.02,
    "obj_000002": 0.06,
    "obj_000004": 0.02,
    "obj_000005": 0.02,
    "obj_000007": 0.05,
    "obj_000008": 0.1,
    "obj_000009": 0.06,
    "obj_000010": 0.06,
    "obj_000011": 0.02,
    "obj_000012": 0.02,
    "obj_000013": 0.02,
    "obj_000014": 0.04,
    "obj_000015": 0.04,
    "obj_000016": 0.02,
    "obj_000017": 0.05,
    "obj_000018": 0.02,
    "obj_000020": 0.08,
    "obj_000021": 0.02,
    "obj_000022": 0.02,
    "obj_000023": 0.03,
    "obj_000024": 0.06,
    "obj_000025": 0.05,
    "obj_000026": 0.02,
    "obj_000027": 0.09,
    "obj_000028": 0.17,
    "obj_000029": 0.02,
    "obj_000030": 0.04,
}

# Scanned models stored Y-up that get pre-rotated to Z-up (≙ main.cpp:665-673)
NAMES_ROTATE = {
    "Armadillo",
    "Asian_Dragon",
    "Dragon",
    "Stanford_Bunny",
    "Happy_Buddha",
    "Thai_Statue",
}


def toward_pose(state: int) -> np.ndarray:
    """Six axis-swap orientations (≙ Share_Data::get_toward_pose)."""
    m = np.eye(4)
    if state == 1:
        m[2, 2] = -1.0
    elif state == 2:
        m[:3, :3] = [[0, 0, 1], [0, 1, 0], [1, 0, 0]]
    elif state == 3:
        m[:3, :3] = [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]
    elif state == 4:
        m[:3, :3] = [[1, 0, 0], [0, 0, 1], [0, 1, 0]]
    elif state == 5:
        m[:3, :3] = [[1, 0, 0], [0, 0, 1], [0, -1, 0]]
    return m


def rotate_z_pose(rotate_state: int) -> np.ndarray:
    ang = np.deg2rad(45.0 * rotate_state)
    c, s = np.cos(ang), np.sin(ang)
    m = np.eye(4)
    m[:2, :2] = [[c, -s], [s, c]]
    return m


@dataclass
class ObjectScene:
    """A prepared object: centered, size-augmented, voxelized."""

    name: str
    points: np.ndarray           # (N, 3) scaled world points, centroid ~ 0
    colors: Optional[np.ndarray]
    predicted_size: float        # bounding radius x 17/16 after scaling
    size: float                  # accepted random size (ShapeNet) or final size
    octomap_resolution: float    # 2*size/32 (≙ main.cpp:967-969)
    min_z_table: float
    gt_scene: VoxelScene = field(repr=False, default=None)
    gt_sample: GTSampleGrid = field(repr=False, default=None)
    view_space: ViewSpace = field(repr=False, default=None)
    ok: bool = True

    @property
    def object_center(self) -> np.ndarray:
        return self.view_space.object_center if self.view_space else np.zeros(3)


def _ensure_viewspace(viewspace_dir: str, n: int, device="cuda") -> np.ndarray:
    """``<dir>/<n>.txt``, generated and written first where it is missing.
    The port's generator draws other start points than the reference's, so
    a pipeline that must match the reference reads the reference's files."""
    try:
        return load_view_space(viewspace_dir, n)
    except (OSError, ValueError):
        pts = generate_hemisphere(n, device=device)
        save_view_space(viewspace_dir, pts)
        return pts


def _size_test_rate(points, colors, cfg: Config, viewspace_dir: str, device="cuda") -> float:
    """Mean non-background pixel fraction over the 5 probe views
    (≙ main.cpp:884-934), all five rendered in one K8 launch, rounded as
    the reference's per-frame ``render_pointcloud``."""
    probe = _ensure_viewspace(viewspace_dir, 5, device)
    centers = points.mean(axis=0)
    views = probe[:5] / np.linalg.norm(probe[:5], axis=1, keepdims=True) * cfg.view_space_radius + centers
    rgba = render_pointcloud_views(
        points, colors, camera_to_world(views, centers), cfg.camera, point_size=cfg.points_size_cloud, device=device,
        rounding="frame",
    )
    return float(np.mean([object_pixel_rate(frame[..., 3]) for frame in rgba]))


def load_object(
    cfg: Config,
    name: Optional[str] = None,
    toward_state: int = 0,
    rotate_state: int = 0,
    rng: Optional[np.random.Generator] = None,
    build_scene: bool = True,
    device="cuda",
) -> ObjectScene:
    """Load + prepare one object (≙ NBV_Net_Labeler ctor, main.cpp:630-1115).

    The size test renders and the ground-truth voxel grid go to ``device``.
    """
    name = name or cfg.name_of_pcd
    rng = rng or np.random.default_rng(cfg.seed)
    if cfg.is_shape_net:
        ply_path = os.path.join(cfg.model_path, "ShapeNet", name + ".ply")
    else:
        ply_path = os.path.join(cfg.model_path, "PLY", name + ".ply")
    points, colors = load_ply(ply_path)

    # orientation (≙ main.cpp:664-745)
    transform = np.eye(4)
    if name in NAMES_ROTATE or cfg.is_shape_net:
        transform = toward_pose(4) @ transform
    transform = rotate_z_pose(rotate_state) @ toward_pose(toward_state) @ transform
    points = points @ transform[:3, :3].T

    # unit heuristic for scanned mm-models (≙ main.cpp:756-765)
    unit = 1.0
    if not cfg.is_shape_net and (np.abs(points) >= 10).any():
        unit = 0.001

    # recenter (≙ main.cpp:786-825)
    points = points - points.mean(axis=0)
    predicted_size = float(np.linalg.norm(points, axis=1).max() * 17.0 / 16.0)

    scale = 1.0
    size = predicted_size
    ok = True
    if not cfg.is_shape_net and name in MP_SCALE:
        scale = (predicted_size - MP_SCALE[name]) / predicted_size

    viewspace_dir = cfg.viewspace_path
    if cfg.is_shape_net:
        # random-size augmentation with persisted size.txt (≙ main.cpp:851-964)
        os.makedirs(cfg.gt_path, exist_ok=True)
        size_file = os.path.join(cfg.gt_path.replace(cfg.name_of_pcd, name), "size.txt")
        os.makedirs(os.path.dirname(size_file), exist_ok=True)
        if os.path.exists(size_file):
            size = float(open(size_file).read().strip())
            if size < 0:
                return ObjectScene(
                    name, points, colors, predicted_size, -1.0, 0.0, 0.0, ok=False
                )
        else:
            lo = cfg.size_min
            tries = 0
            rate = -1.0
            while True:
                size = float(rng.uniform(lo, cfg.size_max))
                lo = size  # monotone retry window (≙ main.cpp:870)
                test_pts = points * (size / predicted_size)
                rate = _size_test_rate(test_pts, colors, cfg, viewspace_dir, device)
                tries += 1
                if rate > cfg.object_pixel_rate or tries > 5:
                    break
            if rate <= cfg.object_pixel_rate:
                with open(size_file, "w") as f:
                    f.write("-1")
                return ObjectScene(
                    name, points, colors, predicted_size, -1.0, 0.0, 0.0, ok=False
                )
            with open(size_file, "w") as f:
                f.write(f"{size}")
        scale = size / predicted_size

    points = points * (scale * unit)
    octomap_resolution = scale * unit * predicted_size * 2.0 / 32.0
    min_z_table = float(points[:, 2].min()) - cfg.ground_truth_resolution

    scene = ObjectScene(
        name=name,
        points=points,
        colors=colors,
        predicted_size=float(np.linalg.norm(points - points.mean(axis=0), axis=1).max() * 17.0 / 16.0),
        size=size if cfg.is_shape_net else scale * unit * predicted_size,
        octomap_resolution=float(octomap_resolution),
        min_z_table=min_z_table,
        ok=ok,
    )
    if build_scene:
        scene.gt_scene = VoxelScene(points, colors, cfg.ground_truth_resolution, device=device)
        scene.gt_sample = make_gt_sample(
            points, points.mean(axis=0), scale * unit * predicted_size
        )
        n_views = cfg.num_of_views
        unit_views = _ensure_viewspace(viewspace_dir, n_views, device)
        scene.view_space = ViewSpace(unit_views, points, cfg.view_space_radius)
    return scene
