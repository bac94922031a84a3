"""Ray generation and NeRF dataset loading from ``transforms.json``.

Counterpart of ``nerf_prv_tpu/nerf/rays.py``.  The loader stays numpy;
pixel directions and the ray bounds are torch functions on the caller's
device.  Everything is mapped into *grid space*, the axis-cycled,
scaled/offset unit cube, so the march sees only unit-cube geometry.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.config import CameraConfig
from ..core.transforms import TransformsFile, load_transforms

# world -> grid axis cycle: grid = (z, x, y) * scale + offset
_CYCLE = np.array([2, 0, 1])


@dataclass
class RayDataset:
    """Per-frame camera data + pixels (numpy, host side)."""

    origins: np.ndarray       # (F, 3) grid-space camera centers
    rotations: np.ndarray     # (F, 3, 3) camera->grid rotation (unscaled)
    pixels: Optional[np.ndarray]  # (F, H, W, 4) float32 in [0,1], or None
    camera: CameraConfig
    scale: float
    offset: np.ndarray

    @property
    def n_frames(self) -> int:
        return len(self.origins)

    @property
    def hw(self) -> Tuple[int, int]:
        return self.camera.height, self.camera.width


def _load_png_rgba(path: str) -> np.ndarray:
    from PIL import Image

    if not os.path.exists(path) and not os.path.splitext(path)[1]:
        # instant-ngp's loader appends ".png" to extensionless file_path
        # entries (the NeRF-synthetic/Blender convention, e.g. "train/r_0")
        path = path + ".png"
    with Image.open(path) as img:
        return np.asarray(img.convert("RGBA"), dtype=np.float32) / 255.0


def grid_cameras(tf: TransformsFile):
    """Camera->grid rotations and grid-space origins for every frame."""
    c2w = tf.cam_to_world  # (F, 4, 4) OpenCV convention in world space
    rot_w = c2w[:, :3, :3]
    pos_w = c2w[:, :3, 3]
    rot_g = rot_w[:, _CYCLE, :]  # cycle world rows -> grid axes
    pos_g = pos_w[:, _CYCLE] * tf.scale + tf.offset[None, :]
    return pos_g.astype(np.float32), rot_g.astype(np.float32)


def load_dataset(json_path: str, with_images: bool = True) -> RayDataset:
    tf = load_transforms(json_path)
    origins, rotations = grid_cameras(tf)
    pixels = None
    if with_images:
        base = os.path.dirname(json_path)
        imgs = [_load_png_rgba(os.path.join(base, fp)) for fp in tf.file_paths]
        pixels = np.stack(imgs, axis=0) if imgs else None
    return RayDataset(
        origins=origins,
        rotations=rotations,
        pixels=pixels,
        camera=tf.camera,
        scale=tf.scale,
        offset=tf.offset,
    )


def pixel_dirs_cam(camera: CameraConfig, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Camera-frame (OpenCV) unit directions through pixel centers.

    Distortion-free pinhole, consistent with the virtual camera's
    projection (the GT renderer and the NeRF share one camera model).
    """
    x = (u + 0.5 - camera.ppx) / camera.fx
    y = (v + 0.5 - camera.ppy) / camera.fy
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def rays_from_pixels(dataset_rot, dataset_org, camera: CameraConfig, frame_idx, u, v):
    """Batched ray origins/dirs in grid space for pixel (u, v) of given frames.

    ``dataset_rot``/``dataset_org``: (F,3,3), (F,3) tensors.  Directions
    are unit-norm in grid space.
    """
    d_cam = pixel_dirs_cam(camera, u, v)  # (N, 3)
    rot = dataset_rot[frame_idx]  # (N, 3, 3)
    d_grid = torch.einsum("nij,nj->ni", rot, d_cam)
    d_grid = d_grid / torch.linalg.norm(d_grid, dim=-1, keepdim=True)
    return dataset_org[frame_idx], d_grid


def ray_aabb(origins, dirs, lo=0.0, hi=1.0):
    """Entry/exit distances of rays with the [lo,hi]^3 grid cube."""
    inv = 1.0 / torch.where(torch.abs(dirs) < 1e-9, torch.full_like(dirs, 1e-9), dirs)
    t0 = (lo - origins) * inv
    t1 = (hi - origins) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    tmin = torch.clamp_min(tmin, 0.0)
    valid = tmax > tmin
    return tmin, torch.maximum(tmax, tmin), valid


def ray_sphere(origins, dirs, center=0.5, radius=0.52):
    """Entry/exit distances with the object's bounding sphere.

    The transforms.json convention maps the object's bounding radius to
    0.5 grid units about the cube center (scale = 0.5/predicted_size), so
    the sphere is a tight bound: rays that miss it contribute nothing.
    """
    oc = origins - center
    b = torch.sum(oc * dirs, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radius * radius
    disc = b * b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    tmin = torch.clamp_min(-b - sq, 0.0)
    tmax = torch.clamp_min(-b + sq, 0.0)
    valid = (disc > 0.0) & (tmax > tmin)
    return tmin, torch.maximum(tmax, tmin), valid
