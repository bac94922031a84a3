"""Ground-truth voxel scene — the OctoMap replacement.

The port of ``nerf_prv_tpu/scene/voxel.py``: the scene is two host arrays
(voxel centres + colours, numpy, as the reference builds them) plus a dense
occupancy/colour grid on the device, which the virtual depth camera
(:func:`precept`) marches through the K9 kernel
(:func:`~..ops.voxel_cast.voxel_cast`), one thread per pixel's ray.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.voxel_cast import voxel_cast


def voxel_downsample(
    points: np.ndarray, colors: Optional[np.ndarray], resolution: float
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """First-point-wins voxelization (≙ octomap insertion, main.cpp:1014-1023).

    Returns (voxel centers, colors, integer keys).
    """
    pts = np.asarray(points)
    keys = np.floor(pts / resolution).astype(np.int64)
    # first occurrence wins, matching the reference's "only if voxel == NULL"
    _, first_idx = np.unique(keys, axis=0, return_index=True)
    first_idx = np.sort(first_idx)
    vkeys = keys[first_idx]
    centers = (vkeys.astype(np.float64) + 0.5) * resolution
    vcolors = None if colors is None else np.asarray(colors)[first_idx]
    return centers, vcolors, vkeys


@dataclass
class GTSampleGrid:
    """32^3 occupancy summary around the object (≙ GT_sample, main.cpp:971-1051)."""

    occupancy: np.ndarray  # (32, 32, 32) bool
    origin: np.ndarray
    resolution: float

    @property
    def init_voxels(self) -> int:
        return int(np.prod(self.occupancy.shape))

    @property
    def occupied_voxels(self) -> int:
        return int(self.occupancy.sum())


def make_gt_sample(
    points: np.ndarray, center: np.ndarray, half_size: float, n: int = 32
) -> GTSampleGrid:
    res = 2.0 * half_size / n
    origin = np.asarray(center) - half_size
    idx = np.floor((np.asarray(points) - origin) / res).astype(np.int64)
    valid = ((idx >= 0) & (idx < n)).all(axis=1)
    occ = np.zeros((n, n, n), dtype=bool)
    occ[tuple(idx[valid].T)] = True
    return GTSampleGrid(occupancy=occ, origin=origin, resolution=res)


class VoxelScene:
    """Dense colour/occupancy grid for the virtual depth camera, on ``device``.

    ``precept``-style ray casting (``main.cpp:98-284``) runs against this
    grid with one fixed-step march per pixel in one kernel launch, in place
    of the reference's per-voxel std::thread fan-out.
    """

    def __init__(
        self,
        points: np.ndarray,
        colors: Optional[np.ndarray],
        resolution: float,
        pad_voxels: int = 2,
        device="cuda",
    ):
        pts = np.asarray(points, dtype=np.float64)
        self.resolution = float(resolution)
        self.centers, self.colors, keys = voxel_downsample(pts, colors, resolution)
        self.full_voxels = len(self.centers)  # ≙ share_data->full_voxels
        kmin = keys.min(axis=0) - pad_voxels
        kmax = keys.max(axis=0) + pad_voxels + 1
        self.origin = kmin.astype(np.float64) * resolution
        dims = kmax - kmin
        occ = np.zeros(dims, dtype=bool)
        col = np.zeros(tuple(dims) + (3,), dtype=np.float32)
        local = keys - kmin
        occ[tuple(local.T)] = True
        if self.colors is not None:
            col[tuple(local.T)] = self.colors.astype(np.float32) / 255.0
        self.device = torch.device(device)
        self.occupancy = torch.from_numpy(occ).to(self.device)
        self.color_grid = torch.from_numpy(col).to(self.device)
        self.dims = np.asarray(dims)

    def cast_rays(
        self, origins, directions, max_range: float = 1.0, steps_per_voxel: float = 2.0
    ):
        """March rays to the first occupied voxel.

        Returns (hit mask, hit points (world), colors in [0,1]) on the
        scene's device.
        """
        n_steps = int(np.ceil(max_range / self.resolution * steps_per_voxel))

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device).reshape(-1, 3).contiguous()

        return voxel_cast(
            self.occupancy, self.color_grid, self.origin, self.resolution,
            f32(origins), f32(directions), max_range, n_steps,
        )


def precept(
    scene: "VoxelScene",
    cam_to_world: np.ndarray,
    intr,
    max_range: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Virtual depth camera: one point per pixel at the first occupied voxel.

    ≙ ``Perception_3D::precept`` (``main.cpp:98-284``): every pixel's ray
    (through the pixel's centre, undistorted by the camera model) marches
    the dense grid.  Returns (hit mask (H,W), points (H,W,3), colors
    (H,W,3)) on the scene's device.
    """
    h, w = intr.height, intr.width
    origins, dirs = precept_rays(cam_to_world, intr, scene.device)
    hit, pos, colr = scene.cast_rays(origins, dirs, max_range=max_range)
    return hit.reshape(h, w), pos.reshape(h, w, 3), colr.reshape(h, w, 3)


def precept_rays(cam_to_world: np.ndarray, intr, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(origins, directions), each (H*W, 3) f32, of the rays
    :func:`precept` casts: through each pixel's centre, undistorted by the
    camera model, turned into the world frame, row by row."""
    from ..core.camera import deproject_pixels

    dev = torch.device(device)
    u, v = np.meshgrid(np.arange(intr.width) + 0.5, np.arange(intr.height) + 0.5)
    px = torch.from_numpy(np.stack([u, v], axis=-1).reshape(-1, 2).astype(np.float32)).to(dev)
    d_cam = deproject_pixels(px, torch.ones(px.shape[0], device=dev), intr)
    c2w = np.asarray(cam_to_world)
    rot = torch.from_numpy(c2w[:3, :3].astype(np.float32)).to(dev)
    # d_cam @ rot.T, summed in a fixed order
    dirs = (d_cam[:, 0:1] * rot[:, 0] + d_cam[:, 1:2] * rot[:, 1]) + d_cam[:, 2:3] * rot[:, 2]
    origins = torch.from_numpy(c2w[:3, 3].astype(np.float32)).to(dev).expand_as(dirs).contiguous()
    return origins, dirs.contiguous()


def colorize_depth(depth: np.ndarray) -> np.ndarray:
    """Jet-like depth colormap, (H, W) -> uint8 (H, W, 3)
    (≙ ``colorize_depth``, Share_Data.hpp)."""
    d = np.asarray(depth, np.float64)
    dmax = d.max() if d.max() > 0 else 1.0
    x = np.clip(d / dmax, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)
