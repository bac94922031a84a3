"""The benchmark's scenes, made from a seed: a frozen generator that imports
nothing of the program.

An object is ``make_object``'s coloured blob (the quality studies' and
``bench.py``'s scene: points on a ball shell of radius 0.035-0.05 with
position-dependent colours).  Its views lie on a hemisphere band at a fixed
radius, a golden-angle spiral turned by an azimuth drawn from the seed, so
that every seed gives the same number of views at the same distances.  Each
frame is the points splatted as squares of ``point_size`` pixels through a
pinhole camera with a z-buffer (the frozen form of the port's plain splat:
nearest point wins, ties to the highest index, white with alpha 0 behind),
on the device, as u8 RGBA.

Cameras are given in the NeRF's grid space as ``transforms.json`` would map
them (``scale = 0.5 / predicted_size``, ``offset = 0.5 + center``, the
world axes cycled to (z, x, y)), so the frames can be handed to the program
in memory.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

GOLDEN_ANGLE = math.pi * (3.0 - math.sqrt(5.0))
_CYCLE = np.array([2, 0, 1])  # world -> grid axis cycle


class Camera(NamedTuple):
    width: int
    height: int
    fx: float
    fy: float
    ppx: float
    ppy: float


class Views(NamedTuple):
    """One object's frames: grid-space cameras and u8 RGBA pixels."""

    origins: np.ndarray    # (F, 3) float32
    rotations: np.ndarray  # (F, 3, 3) float32, camera -> grid
    pixels: np.ndarray     # (F, H, W, 4) uint8
    scale: float
    offset: np.ndarray


def make_object(n: int, seed: int, size: float = 0.05):
    """(n, 3) float64 points and (n, 3) uint8 colours of the blob."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3))
    pts = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= size * rng.uniform(0.7, 1.0, size=(n, 1))
    cols = np.clip(((pts / size) * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    return pts, cols


def view_dirs(n: int, azimuth: float, elevation_deg=(15.0, 75.0)) -> np.ndarray:
    """(n, 3) unit directions: a golden-angle spiral over the band of
    elevations, turned by ``azimuth`` about +z."""
    lo, hi = (math.sin(math.radians(e)) for e in elevation_deg)
    i = np.arange(n, dtype=np.float64)
    z = lo + (hi - lo) * (i + 0.5) / n
    phi = azimuth + i * GOLDEN_ANGLE
    r = np.sqrt(1.0 - z * z)
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)


def look_at(positions: np.ndarray, center: np.ndarray) -> np.ndarray:
    """(F, 4, 4) OpenCV camera-to-world poses (x right, y down, z forward)
    looking at ``center`` with +z up."""
    f = center[None, :] - positions
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    right = np.cross(f, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    down = np.cross(f, right)
    c2w = np.tile(np.eye(4), (len(positions), 1, 1))
    c2w[:, :3, 0], c2w[:, :3, 1], c2w[:, :3, 2], c2w[:, :3, 3] = right, down, f, positions
    return c2w


@torch.no_grad()
def splat(points: torch.Tensor, colors01: torch.Tensor, c2w: np.ndarray, cam: Camera,
          point_size: int) -> torch.Tensor:
    """u8 RGBA (F, H, W, 4) on the points' device."""
    dev = points.device
    w, h, ps = cam.width, cam.height, int(point_size)
    drop = w * h
    half = ps // 2
    offs = torch.arange(-half, ps - half, device=dev)
    du, dv = torch.meshgrid(offs, offs, indexing="ij")
    du, dv = du.reshape(-1), dv.reshape(-1)
    k = ps * ps
    index = torch.arange(points.shape[0], device=dev).repeat_interleave(k)
    white_last = torch.cat([colors01, torch.ones((1, 3), dtype=torch.float32, device=dev)])
    w2c = torch.from_numpy(np.linalg.inv(c2w)[:, :3, :4].astype(np.float32)).to(dev)
    frames = []
    for m in w2c:
        pc = points @ m[:, :3].T + m[:, 3]
        z = pc[:, 2]
        zd = torch.clamp(z, min=1e-9)
        uf = torch.floor(pc[:, 0] / zd * cam.fx + cam.ppx)
        vf = torch.floor(pc[:, 1] / zd * cam.fy + cam.ppy)
        valid = (z > 1e-6) & (uf >= -ps) & (uf < w + ps) & (vf >= -ps) & (vf < h + ps)
        ui = torch.where(valid, uf, torch.zeros_like(uf)).to(torch.int64)
        vi = torch.where(valid, vf, torch.zeros_like(vf)).to(torch.int64)
        uu = (ui[:, None] + du[None, :]).reshape(-1)
        vv = (vi[:, None] + dv[None, :]).reshape(-1)
        zz = z.repeat_interleave(k)
        ok = valid.repeat_interleave(k) & (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
        flat = torch.where(ok, vv * w + uu, torch.full_like(uu, drop))
        zbuf = torch.full((drop + 1,), float("inf"), dtype=torch.float32, device=dev)
        zbuf.scatter_reduce_(0, flat, torch.where(ok, zz, torch.full_like(zz, float("inf"))), "amin")
        win = ok & (zz <= zbuf[flat] + 1e-7)
        winner = torch.full((drop + 1,), -1, dtype=torch.int64, device=dev)
        winner.scatter_reduce_(0, torch.where(win, flat, torch.full_like(flat, drop)), index, "amax")
        rgb = white_last[winner[:drop]]
        alpha = (zbuf[:drop] < float("inf")).to(torch.float32)
        rgba = torch.cat([rgb, alpha[:, None]], dim=-1).reshape(h, w, 4)
        frames.append(torch.round(rgba * 255.0).to(torch.uint8))
    return torch.stack(frames)


def object_views(obj_seed: int, n_views: int, azimuth: float, cam: Camera, n_points: int,
                 point_size: int, radius: float, elevation_deg, device) -> Views:
    """The frames of object ``obj_seed`` from ``n_views`` views."""
    pts, cols = make_object(n_points, obj_seed)
    center = pts.mean(axis=0)
    predicted_size = float(np.linalg.norm(pts - center, axis=1).max() * 17 / 16)
    positions = view_dirs(n_views, azimuth, elevation_deg) * radius + center
    c2w = look_at(positions, center)
    pixels = splat(torch.from_numpy(pts.astype(np.float32)).to(device),
                   torch.from_numpy(cols.astype(np.float32) / 255.0).to(device), c2w, cam, point_size)
    scale = 0.5 / predicted_size
    offset = 0.5 + center[_CYCLE]
    origins = c2w[:, :3, 3][:, _CYCLE] * scale + offset[None, :]
    rotations = c2w[:, :3, :3][:, _CYCLE, :]
    return Views(origins.astype(np.float32), rotations.astype(np.float32), pixels.cpu().numpy(), scale, offset)


def seeds(seed: int, tag: str, n: int) -> list:
    """``n`` 63-bit integers drawn from (``seed``, ``tag``): the same run seed
    always gives the same objects, call seeds and samples."""
    words = np.random.SeedSequence([int(seed) % (1 << 64), *tag.encode()]).generate_state(2 * n, np.uint32)
    return [int(words[2 * i]) << 31 ^ int(words[2 * i + 1]) for i in range(n)]


def azimuths(seed: int, tag: str, n: int) -> list:
    return [s / float(1 << 63) * 2.0 * math.pi for s in seeds(seed, tag + ".azimuth", n)]
