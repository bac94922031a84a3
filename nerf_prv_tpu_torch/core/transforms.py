"""instant-ngp ``transforms.json`` schema: writers, readers, coordinate maps.

Honors the exact schema the reference emits (``main.cpp:1584-1651``):
``camera_angle_x/y``, ``fl_x/fl_y/k1/k2/k3/p1/p2/cx/cy/w/h``, ``aabb_scale``,
``scale = 0.5 / predicted_size``, ``offset = 0.5 + center.(z,x,y)`` and
per-frame camera-to-world matrices remapped by (x,y,z)->(y,z,x) then
(x,y,z)->(x,-y,-z) (``main.cpp:1629-1640``) so files interchange with
instant-ngp and with the reference's artifacts.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from .config import CameraConfig

# x,y,z -> y,z,x axis cycle (≙ main.cpp:1630-1633): AXIS_CYCLE @ v = (vz, vx, vy)
AXIS_CYCLE = np.array(
    [
        [0.0, 0.0, 1.0, 0.0],
        [1.0, 0.0, 0.0, 0.0],
        [0.0, 1.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
)
# OpenCV camera (+Y down, +Z forward) -> OpenGL camera (≙ main.cpp:1636-1639)
CV_TO_GL = np.diag([1.0, -1.0, -1.0, 1.0])


def remap_pose(cam_to_world: np.ndarray) -> np.ndarray:
    """World camera pose -> json ``transform_matrix`` (≙ main.cpp:1629-1640)."""
    return AXIS_CYCLE @ np.asarray(cam_to_world) @ CV_TO_GL


def unmap_pose(transform_matrix: np.ndarray) -> np.ndarray:
    """json ``transform_matrix`` -> OpenCV-convention camera-to-world."""
    return AXIS_CYCLE.T @ np.asarray(transform_matrix) @ CV_TO_GL


def world_to_grid(points: np.ndarray, scale: float, offset: Sequence[float]):
    """World xyz -> NeRF unit-cube coords: cycle axes, scale, offset.

    Matches instant-ngp's interpretation of the json ``scale``/``offset``
    applied to the (already axis-cycled) frame positions.
    """
    pts = np.asarray(points)
    cycled = np.stack([pts[..., 2], pts[..., 0], pts[..., 1]], axis=-1)
    return cycled * scale + np.asarray(offset)


@dataclass
class TransformsFile:
    """Parsed transforms.json."""

    camera: CameraConfig
    aabb_scale: int
    scale: float
    offset: np.ndarray
    file_paths: List[str]
    matrices: np.ndarray  # (N, 4, 4) json-convention transform matrices

    @property
    def cam_to_world(self) -> np.ndarray:
        """(N, 4, 4) OpenCV-convention camera-to-world matrices."""
        return np.einsum("ij,njk,kl->nil", AXIS_CYCLE.T, self.matrices, CV_TO_GL)


def make_root(
    camera: CameraConfig,
    aabb_scale: int,
    predicted_size: float,
    object_center: Sequence[float],
) -> dict:
    """Json header (≙ main.cpp:1584-1602)."""
    cx, cy, cz = [float(v) for v in object_center]
    return {
        "camera_angle_x": 2.0 * math.atan(0.5 * camera.width / camera.fx),
        "camera_angle_y": 2.0 * math.atan(0.5 * camera.height / camera.fy),
        "fl_x": camera.fx,
        "fl_y": camera.fy,
        "k1": camera.k1,
        "k2": camera.k2,
        "k3": camera.k3,
        "p1": camera.p1,
        "p2": camera.p2,
        "cx": camera.ppx,
        "cy": camera.ppy,
        "w": camera.width,
        "h": camera.height,
        "aabb_scale": aabb_scale,
        "scale": 0.5 / predicted_size,
        "offset": [0.5 + cz, 0.5 + cx, 0.5 + cy],
        "frames": [],
    }


def scaled_camera(camera: CameraConfig, factor: float) -> CameraConfig:
    """1/``factor``-resolution intrinsics with zeroed distortion for candidate
    scoring renders (≙ main.cpp:1794-1806, factor 16)."""
    return CameraConfig(
        width=int(camera.width / factor),
        height=int(camera.height / factor),
        fx=camera.fx / factor,
        fy=camera.fy / factor,
        ppx=camera.ppx / factor,
        ppy=camera.ppy / factor,
        model=0,
        k1=0.0,
        k2=0.0,
        k3=0.0,
        p1=0.0,
        p2=0.0,
    )


def add_frame(root: dict, file_path: str, cam_to_world: np.ndarray) -> None:
    root["frames"].append(
        {
            "file_path": file_path,
            "transform_matrix": remap_pose(cam_to_world).tolist(),
        }
    )


def write_transforms(path: str, root: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(root, f, indent=2)


def load_transforms(path: str) -> TransformsFile:
    with open(path) as f:
        root = json.load(f)
    camera = CameraConfig(
        width=int(root["w"]),
        height=int(root["h"]),
        fx=float(root["fl_x"]),
        fy=float(root["fl_y"]),
        ppx=float(root["cx"]),
        ppy=float(root["cy"]),
        model=2 if any(abs(float(root.get(k, 0.0))) > 0 for k in ("k1", "k2", "k3", "p1", "p2")) else 0,
        k1=float(root.get("k1", 0.0)),
        k2=float(root.get("k2", 0.0)),
        k3=float(root.get("k3", 0.0)),
        p1=float(root.get("p1", 0.0)),
        p2=float(root.get("p2", 0.0)),
    )
    frames = root.get("frames", [])
    mats = np.array([f["transform_matrix"] for f in frames], dtype=np.float64)
    if mats.size == 0:
        mats = np.zeros((0, 4, 4))
    return TransformsFile(
        camera=camera,
        aabb_scale=int(root.get("aabb_scale", 1)),
        scale=float(root.get("scale", 1.0)),
        offset=np.asarray(root.get("offset", [0.5, 0.5, 0.5]), dtype=np.float64),
        file_paths=[f["file_path"] for f in frames],
        matrices=mats,
    )
