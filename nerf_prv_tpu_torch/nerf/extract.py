"""Geometry export and camera-path video rendering.

Counterpart of ``nerf_prv_tpu/nerf/extract.py``: ``--save_mesh`` (the
density-thresholded surface as a coloured PLY point cloud, a drop-in for
tools that consumed the reference's marching-cubes mesh) and
``--video_camera_path`` (frames rendered through the batched path and
stitched with ffmpeg when it is installed).  Both run on the device of the
parameters.
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional

import numpy as np
import torch

from ..scene.ply import save_ply_binary
from .model import NerfConfig, density, field
from .rays import load_dataset
from .render import build_render_aux, render_views


def _device(params):
    return next(iter(params.values())).device


@torch.no_grad()
def extract_density_grid(params, cfg: NerfConfig, resolution: int = 128, chunk: int = 1 << 17):
    """Sample the field's density on a resolution^3 grid -> (R, R, R) numpy array."""
    lin = (np.arange(resolution) + 0.5) / resolution
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1).reshape(-1, 3)
    pts = torch.as_tensor(pts, dtype=torch.float32, device=_device(params))
    out = [density(params, pts[i : i + chunk], cfg) for i in range(0, len(pts), chunk)]
    return torch.cat(out).reshape(resolution, resolution, resolution).cpu().numpy()


@torch.no_grad()
def save_geometry(
    params,
    cfg: NerfConfig,
    out_ply: str,
    resolution: int = 128,
    density_threshold: float = 10.0,
    chunk: int = 1 << 17,
) -> int:
    """Export the density-thresholded surface as a coloured PLY point cloud
    (≙ --save_mesh).  Returns the number of exported points."""
    grid = extract_density_grid(params, cfg, resolution, chunk)
    occ = grid > density_threshold
    # keep surface cells only: occupied with at least one empty neighbour
    # (outside the grid counts as empty: no periodic wrap)
    padded = np.pad(occ, 1, constant_values=False)
    interior = occ.copy()
    r = resolution
    for axis in range(3):
        sl_lo = [slice(1, r + 1)] * 3
        sl_hi = [slice(1, r + 1)] * 3
        sl_lo[axis] = slice(0, r)
        sl_hi[axis] = slice(2, r + 2)
        interior &= padded[tuple(sl_lo)] & padded[tuple(sl_hi)]
    surface = occ & ~interior
    # argwhere hands back a transposed view; the field wants contiguous rows
    pts = np.ascontiguousarray((np.argwhere(surface) + 0.5) / resolution)
    if len(pts) == 0:
        save_ply_binary(out_ply, np.zeros((0, 3)), np.zeros((0, 3), np.uint8))
        return 0
    device = _device(params)
    pts_t = torch.as_tensor(pts, dtype=torch.float32, device=device)
    up = torch.tensor([0.0, 0.0, 1.0], device=device)
    cols = []
    for i in range(0, len(pts), chunk):
        part = pts_t[i : i + chunk]
        _, rgb = field(params, part, up.expand(part.shape[0], 3).contiguous(), cfg)
        cols.append(rgb)
    colors = (torch.clamp(torch.cat(cols), 0, 1) * 255).to(torch.uint8).cpu().numpy()
    save_ply_binary(out_ply, pts, colors)
    return len(pts)


@torch.no_grad()
def render_video(
    params,
    camera_path_json: str,
    out_path: str,
    cfg: Optional[NerfConfig] = None,
    fps: int = 30,
) -> int:
    """Render every frame of a transforms-style camera path; writes
    ``frame_%04d.png`` into ``<out_path stem>_frames`` and stitches an mp4
    with ffmpeg when it is available (the frames stay on disk either way).
    Returns the frame count."""
    from PIL import Image

    cfg = cfg or NerfConfig()
    ds = load_dataset(camera_path_json, with_images=False)
    frames_dir = os.path.splitext(out_path)[0] + "_frames"
    os.makedirs(frames_dir, exist_ok=True)
    aux = build_render_aux(params, cfg)  # once per video, not per group
    group = 8
    count = 0
    for start in range(0, ds.n_frames, group):
        stop = min(start + group, ds.n_frames)
        imgs = render_views(
            params, ds.origins[start:stop], ds.rotations[start:stop], ds.camera, cfg, aux=aux
        )
        u8 = torch.clamp(torch.round(imgs[..., :3] * 255), 0, 255).to(torch.uint8).cpu().numpy()
        for i in range(stop - start):
            Image.fromarray(u8[i], "RGB").save(
                os.path.join(frames_dir, f"frame_{start + i:04d}.png")
            )
            count += 1
    try:
        subprocess.run(
            [
                "ffmpeg", "-y", "-framerate", str(fps),
                "-i", os.path.join(frames_dir, "frame_%04d.png"),
                "-c:v", "libx264", "-pix_fmt", "yuv420p", out_path,
            ],
            check=True,
            capture_output=True,
        )
    except (OSError, subprocess.CalledProcessError):
        pass  # frames remain on disk when ffmpeg is unavailable
    return count
