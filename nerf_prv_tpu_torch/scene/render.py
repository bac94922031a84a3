"""Virtual camera: the point-splat rasterizer of the coverage-dataset path.

The port of ``nerf_prv_tpu/scene/render.py``.  Each ground-truth point is
splatted as a ``point_size`` x ``point_size`` square with a z-buffer on a
white background (≙ the reference's offscreen PCL/VTK screenshots,
``main.cpp:68-96``), through the K8 kernel (:func:`~..ops.splat.splat`),
one launch for all frames of a view set.

The output orientation is the final ``rgbaClip`` one: pixel (u, v) is the
distortion-aware pinhole projection with +x right, +y down, rounded to the
nearest pixel, so pixel i is centred at i and models 1-2 distort; the
NeRF's rays (``nerf/rays.py``) shoot through i + 0.5 on an undistorted
pinhole.  The port keeps that misregistration of the reference, so that its
renders, and the PSNRs measured on them, are the reference's.

Three workarounds of the TPU reference are gone, none of which changed its
output: the power-of-two bucket the point axis was padded to
(``_pad_points_bucket``: one compiled program per bucket, not per point
count), the bucket the frame axis was padded to (one program per bucket of
view counts), and the 2^17-point slabs (scatters beyond ~6.2 M rows faulted
the TPU worker).  A CUDA kernel takes any point and frame count as it is.
``lax.map`` over frames is gone too: the kernel holds every frame's z-buffer
at once (8 bytes a pixel of scratch, 0.74 GB for 100 frames at 1280x720).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.splat import FUSED_ROWS, splat


def _colors01(colors, n: int, device) -> torch.Tensor:
    """(n, 3) f32 colours in [0, 1]: zeros without colours; divided by 255
    only where the largest value exceeds 1.5.  The reference also tests
    whether the dtype is not float32 after casting to float32, which never
    holds, so u8 colours that are all <= 1 stay unscaled there and here."""
    if colors is None:
        return torch.zeros((n, 3), dtype=torch.float32, device=device)
    col = torch.as_tensor(np.asarray(colors) if not torch.is_tensor(colors) else colors)
    col = col.to(device=device, dtype=torch.float32)
    if float(col.max()) > 1.5:
        col = col / 255.0
    return col.contiguous()


def _world_to_camera(cam_to_world) -> torch.Tensor:
    """(F, 3, 4) f32 world-to-camera matrices: the float64 inverse of each
    camera-to-world pose, cast to f32 (as the reference does on the host)."""
    c2w = np.asarray(cam_to_world, np.float64).reshape(-1, 4, 4)
    w2c = np.linalg.inv(c2w)[:, :3, :4]
    return torch.from_numpy(np.ascontiguousarray(w2c, dtype=np.float32))


def _points(points_world, device) -> torch.Tensor:
    if torch.is_tensor(points_world):
        return points_world.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(points_world, dtype=np.float32)).to(device)


def render_pointcloud_views(
    points_world,
    colors,
    cam_to_world_batch: np.ndarray,  # (F, 4, 4)
    intr,
    point_size: Optional[int] = None,
    device="cuda",
    rounding: str = "views",
) -> torch.Tensor:
    """All frames of a view set in one kernel launch -> uint8 RGBA
    (F, H, W, 4) on ``device``.  ``rounding="frame"`` rounds the transform
    as the reference's ``render_pointcloud`` does (``ops/splat.py::FUSED_ROWS``),
    so that the frames' bytes equal :func:`render_pointcloud` +
    :func:`rgba_from_render`'s."""
    device = torch.device(device)
    pts = _points(points_world, device)
    col = _colors01(colors, len(pts), device)
    w2c = _world_to_camera(cam_to_world_batch).to(device)
    return splat(pts, col, w2c, intr, int(point_size) if point_size else 5, fused_rows=FUSED_ROWS[rounding])


def render_pointcloud(
    points_world,
    colors,
    cam_to_world: np.ndarray,
    intr,
    point_size: Optional[int] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a point cloud; returns (rgb float [0,1] HxWx3, alpha HxW) on
    ``device``.

    Background is white with alpha 0 (≙ PCL white background +
    ``convertToAlpha``, ``Share_Data.hpp:765-778``).
    """
    device = torch.device(device)
    pts = _points(points_world, device)
    col = _colors01(colors, len(pts), device)
    w2c = _world_to_camera(cam_to_world).to(device)
    rgb, alpha = splat(pts, col, w2c, intr, int(point_size) if point_size else 5, rgba_u8=False,
                       fused_rows=FUSED_ROWS["frame"])
    return rgb[0], alpha[0]


def rgba_from_render(rgb, alpha) -> np.ndarray:
    """uint8 RGBA image (white background kept under alpha=0, matching the
    reference's convertToAlpha output); rounding half to even."""
    rgb = torch.as_tensor(rgb).detach().cpu()
    alpha = torch.as_tensor(alpha).detach().cpu()
    rgb8 = torch.round(torch.clamp(rgb, 0, 1) * 255).to(torch.uint8)
    a8 = torch.round(alpha * 255).to(torch.uint8)
    return torch.cat([rgb8, a8[..., None]], dim=-1).numpy()


def object_pixel_rate(alpha) -> float:
    """Fraction of non-background pixels (≙ size test, main.cpp:917-934)."""
    if torch.is_tensor(alpha):
        return int((alpha > 0).sum()) / alpha.numel()
    return float((np.asarray(alpha) > 0).mean())


def colorfulness(rgb01) -> float:
    """Hasler–Süsstrunk colorfulness metric (≙ ColorfulNess,
    ``Share_Data.hpp``): std/mean statistics of rg=R-G and yb=(R+G)/2-B."""
    if torch.is_tensor(rgb01):
        rgb01 = rgb01.detach().cpu().numpy()
    img = np.asarray(rgb01, np.float64) * 255.0
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    rg = r - g
    yb = 0.5 * (r + g) - b
    std = np.sqrt(rg.std() ** 2 + yb.std() ** 2)
    mean = np.sqrt(rg.mean() ** 2 + yb.mean() ** 2)
    return float(std + 0.3 * mean)
