"""Camera model: pinhole projection with RealSense-style distortion.

The port of ``nerf_prv_tpu/core/camera.py``: the same batched functions
over points and pixels, on tensors, with the same distortion models (none,
modified/inverse Brown-Conrady, F-theta, Kannala-Brandt 4) and the same
order of f32 operations.  ``DIST_BROWN_CONRADY`` (4) passes through
untouched in both directions, as in the reference.
"""

from __future__ import annotations

import torch

# rs2_distortion enum values (≙ Share_Data.hpp:67-76)
DIST_NONE = 0
DIST_MODIFIED_BROWN_CONRADY = 1
DIST_INVERSE_BROWN_CONRADY = 2
DIST_FTHETA = 3
DIST_BROWN_CONRADY = 4
DIST_KANNALA_BRANDT4 = 5

_EPS = float(torch.finfo(torch.float32).eps)


def _as_f32(a, device="cuda") -> torch.Tensor:
    """A tensor stays on its device; anything else goes to ``device``."""
    if torch.is_tensor(a):
        return a.to(torch.float32)
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _distort_brown_conrady(x, y, coeffs):
    """Forward Brown-Conrady distortion (≙ Share_Data.hpp:96-108)."""
    k1, k2, k3, p1, p2 = coeffs
    r2 = x * x + y * y
    f = 1.0 + k1 * r2 + k2 * r2 * r2 + p2 * r2 * r2 * r2
    xf = x * f
    yf = y * f
    dx = xf + 2.0 * k3 * xf * yf + p1 * (r2 + 2.0 * xf * xf)
    dy = yf + 2.0 * p1 * xf * yf + k3 * (r2 + 2.0 * yf * yf)
    return dx, dy


def _f32_tan(v: float) -> float:
    """tan of ``v`` in f32 (the reference takes it on a weak-typed f32 array)."""
    return float(torch.tan(torch.tensor(v, dtype=torch.float32)))


def _distort_ftheta(x, y, coeffs):
    """F-theta fisheye distortion (≙ Share_Data.hpp:109-119)."""
    k1 = float(coeffs[0])
    r = torch.clamp(torch.sqrt(x * x + y * y), min=_EPS)
    rd = (1.0 / k1) * torch.atan(2.0 * r * _f32_tan(k1 / 2.0))
    return x * rd / r, y * rd / r


def _distort_kb4(x, y, coeffs):
    """Kannala-Brandt 4-parameter distortion (≙ Share_Data.hpp:120-133)."""
    k1, k2, k3, k4 = coeffs[0], coeffs[1], coeffs[2], coeffs[3]
    r = torch.clamp(torch.sqrt(x * x + y * y), min=_EPS)
    theta = torch.atan(r)
    t2 = theta * theta
    series = 1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))
    rd = theta * series
    return x * rd / r, y * rd / r


def project_points(points, intr, device="cuda") -> torch.Tensor:
    """Project camera-frame points (..., 3) to pixel coords (..., 2), f32.

    ≙ ``rs2_project_point_to_pixel`` (``Share_Data.hpp:92-137``), batched.
    ``intr`` is a :class:`~nerf_prv_tpu_torch.core.config.CameraConfig`.
    A tensor stays on its device; anything else goes to ``device``.
    """
    points = _as_f32(points, device)
    x = points[..., 0] / points[..., 2]
    y = points[..., 1] / points[..., 2]
    model = int(intr.model)
    if model in (DIST_MODIFIED_BROWN_CONRADY, DIST_INVERSE_BROWN_CONRADY):
        x, y = _distort_brown_conrady(x, y, intr.coeffs)
    elif model == DIST_FTHETA:
        x, y = _distort_ftheta(x, y, intr.coeffs)
    elif model == DIST_KANNALA_BRANDT4:
        x, y = _distort_kb4(x, y, intr.coeffs)
    u = x * intr.fx + intr.ppx
    v = y * intr.fy + intr.ppy
    return torch.stack([u, v], dim=-1)


def _undistort_inverse_brown_conrady(x, y, coeffs):
    """≙ Share_Data.hpp:147-155 (single forward-polynomial application)."""
    k1, k2, k3, p1, p2 = coeffs
    r2 = x * x + y * y
    f = 1.0 + k1 * r2 + k2 * r2 * r2 + p2 * r2 * r2 * r2
    ux = x * f + 2.0 * k3 * x * y + p1 * (r2 + 2.0 * x * x)
    uy = y * f + 2.0 * p1 * x * y + k3 * (r2 + 2.0 * y * y)
    return ux, uy


def _undistort_kb4(x, y, coeffs):
    """Newton inversion of the KB4 model (≙ Share_Data.hpp:156-180): the
    reference's 4-step ``lax.scan`` as a loop."""
    k1, k2, k3, k4 = coeffs[0], coeffs[1], coeffs[2], coeffs[3]
    rd = torch.clamp(torch.sqrt(x * x + y * y), min=_EPS)
    theta = rd
    for _ in range(4):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - rd
        df = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + 9.0 * t2 * k4)))
        theta = theta - f / df
    r = torch.tan(theta)
    return x * r / rd, y * r / rd


def _undistort_ftheta(x, y, coeffs):
    """≙ Share_Data.hpp:181-191."""
    k1 = float(coeffs[0])
    rd = torch.clamp(torch.sqrt(x * x + y * y), min=_EPS)
    r = torch.tan(k1 * rd) / float(torch.atan(torch.tensor(2.0 * _f32_tan(k1 / 2.0))))
    return x * r / rd, y * r / rd


def deproject_pixels(pixels, depth, intr, device="cuda") -> torch.Tensor:
    """Deproject pixel coords (..., 2) at the given depth to camera-frame
    points (..., 3), f32.

    ≙ ``rs2_deproject_pixel_to_point`` (``Share_Data.hpp:140-196``), batched.
    """
    pixels = _as_f32(pixels, device)
    depth = torch.as_tensor(depth, dtype=torch.float32, device=pixels.device)
    x = (pixels[..., 0] - intr.ppx) / intr.fx
    y = (pixels[..., 1] - intr.ppy) / intr.fy
    model = int(intr.model)
    if model == DIST_INVERSE_BROWN_CONRADY:
        x, y = _undistort_inverse_brown_conrady(x, y, intr.coeffs)
    elif model == DIST_KANNALA_BRANDT4:
        x, y = _undistort_kb4(x, y, intr.coeffs)
    elif model == DIST_FTHETA:
        x, y = _undistort_ftheta(x, y, intr.coeffs)
    depth = torch.broadcast_to(depth, x.shape)
    return torch.stack([depth * x, depth * y, depth], dim=-1)


def pixels_to_ray_ends(pixels, cam_to_world, intr, max_range=1.0, device="cuda") -> torch.Tensor:
    """World-frame points at ``max_range`` depth through each pixel.

    ≙ ``project_pixel_to_ray_end`` (``Share_Data.hpp:719-726``), batched.
    ``cam_to_world`` is a (4, 4) camera-to-world matrix.
    """
    pixels = _as_f32(pixels, device)
    pts_cam = deproject_pixels(pixels, torch.full(pixels.shape[:-1], float(max_range), device=pixels.device),
                               intr)
    c2w = torch.as_tensor(cam_to_world, dtype=torch.float32, device=pixels.device)
    return pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
