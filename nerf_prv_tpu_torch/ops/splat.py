"""Point-splat z-buffer (K8): CUDA kernel wrapper + plain version.

The kernel (``csrc/splat.cu``, hand-written for sm_90a) replaces
``nerf_prv_tpu/scene/render.py::_splat_core`` and its frame batch
``_splat_batch_u8``, which the reference computes with XLA scatters (no
Pallas kernel).  For each frame every point is moved by the frame's f32
world-to-camera matrix, projected (Brown-Conrady distortion for camera
models 1-2), rounded half to even to a pixel and splatted as a
``point_size``² square; each pixel keeps its nearest depth, and the colour
of the highest-indexed point within 1e-7 of that depth is written over a
white background, alpha = covered.

The tie rule is the reference's on the CPU, where XLA's scatter applies its
updates in order and the last writer (the highest point index) wins.  The
pixel grid is the reference's too: pixel i holds projections in
[i - 0.5, i + 0.5), centred at i, not at i + 0.5 as the NeRF's rays assume.

:func:`bin_counts_plain` is the kernel's binning of splats by screen tile,
and :func:`bin_capacity` the size of its bins, taken from the shapes alone.

:func:`splat` takes the plain version only for tensors on the CPU.  For
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build


def _lib() -> ctypes.CDLL:
    return bind(_build.load("splat"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures on a build of ``csrc/splat.cu``."""
    fn = lib.splat_forward
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # points, colors, w2c
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, frames, width, height
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),  # point size, model, fused rows, intr
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # counts, cursors, bins, capacity
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # rgba, alpha, out_u8
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.splat_tile_side.argtypes = []
        lib.splat_tile_side.restype = ctypes.c_int
        lib.splat_error_string.argtypes = [ctypes.c_int]
        lib.splat_error_string.restype = ctypes.c_char_p
    return lib


def _intrinsics(camera) -> list:
    """fx, fy, ppx, ppy, k1, k2, k3, p1, p2 as f32 values (the reference
    casts each with ``jnp.float32``)."""
    vals = (camera.fx, camera.fy, camera.ppx, camera.ppy, *camera.coeffs)
    return [float(np.float32(v)) for v in vals]


def _check_args(points, colors01, w2c, point_size) -> None:
    """Raise ValueError on anything the kernel does not take."""
    for name, t in (("points", points), ("colors01", colors01), ("w2c", w2c)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"splat needs contiguous float32 {name}; got {t.dtype}")
        if t.device != points.device:
            raise ValueError(f"{name} on {t.device} but points on {points.device}")
    if points.dim() != 2 or points.shape[1] != 3 or colors01.shape != points.shape:
        raise ValueError(f"points and colors01 must be (N, 3); got {tuple(points.shape)}, {tuple(colors01.shape)}")
    if w2c.dim() != 3 or w2c.shape[1:] != (3, 4) or w2c.shape[0] == 0:
        raise ValueError(f"w2c must be (F, 3, 4) with F >= 1; got {tuple(w2c.shape)}")
    if points.shape[0] >= 2**31 or int(point_size) < 1:
        raise ValueError(f"splat takes fewer than 2^31 points and a point size >= 1; got "
                         f"{points.shape[0]}, {point_size}")


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` for an f32 tensor ``a`` (``b`` and ``c`` f32 tensors or
    f32 values), rounded once to f32 (a fused
    multiply-add, which PyTorch does not offer): the product is exact in
    float64, the sum's float64 rounding error is recovered exactly (TwoSum),
    and where the float64 sum fell on a midpoint of two f32 values the
    result is the neighbour on the error's side."""
    s = a.double() * (b.double() if torch.is_tensor(b) else float(b))  # exact: 48 significant bits
    c64 = c.double() if torch.is_tensor(c) else float(c)
    r = s + c64
    bb = r - s
    err = (s - (r - bb)) + (c64 - bb)
    out = r.float()
    near = out.double()
    other = torch.nextafter(out, torch.where(r > near, torch.full_like(out, math.inf), torch.full_like(out, -math.inf)))
    mid = (near != r) & ((r - near).abs() == (other.double() - r).abs())
    return torch.where(mid & (err != 0) & ((other.double() > near) == (err > 0)), other, out)


# The reference's f32 on the CPU: its compiled elementwise code fuses each multiply into the add that takes it,
# and XLA's dot of the points with the (3, 3) rotation sums some rows of the transform as a chain of fused
# multiply-adds and others as plain products in order.  The transform, the distortion and the pixel below are
# written so, operation for operation (the kernel with __fmaf_rn), so that every rounding is the reference's.
# Which rows the dot fuses (bit r: row r) depends on how it ran, measured on the CPU at 3,000 to 200,003 points:
FUSED_ROWS = {
    "views": 0b111,  # render_pointcloud_views: the dot compiled with the splat (jit)
    "frame": 0b100,  # render_pointcloud: the dot dispatched on its own, before the compiled splat
}


def _transform_row(p0, p1, p2, row, fused: bool):
    """One row of the world-to-camera transform, then the translation added."""
    if fused:
        dot = fma32(p2, row[2], fma32(p1, row[1], p0 * row[0]))
    else:
        dot = (p0 * row[0] + p1 * row[1]) + p2 * row[2]
    return dot + row[3]


def _distort(x, y, coeffs):
    """``core/camera.py::_distort_brown_conrady`` with the reference's fused
    multiply-adds."""
    k1, k2, k3, p1, p2 = coeffs
    r2 = fma32(x, x, y * y)
    f = fma32((p2 * r2) * r2, r2, fma32(k2 * r2, r2, fma32(r2, k1, 1.0)))
    xf, yf = x * f, y * f
    dx = fma32(fma32(2.0 * xf, xf, r2), p1, fma32((2.0 * k3) * xf, yf, xf))
    dy = fma32(fma32(2.0 * yf, yf, r2), k3, fma32((2.0 * p1) * xf, yf, yf))
    return dx, dy


def _frame_projection(points, m, camera, point_size, fused_rows: int = FUSED_ROWS["views"]):
    """Pixel (float, rounded), depth and validity of every point in the frame
    of the (3, 4) world-to-camera matrix ``m``, in the kernel's order of f32
    operations (never a matmul, whose summation order is its own)."""
    from ..core.camera import DIST_INVERSE_BROWN_CONRADY, DIST_MODIFIED_BROWN_CONRADY

    p0, p1, p2 = points[:, 0], points[:, 1], points[:, 2]
    xc, yc, z = (_transform_row(p0, p1, p2, m[r], bool(fused_rows >> r & 1)) for r in range(3))
    zd = torch.clamp(z, min=1e-9)
    x, y = xc / zd, yc / zd
    fx, fy, ppx, ppy, *coeffs = _intrinsics(camera)
    if int(camera.model) in (DIST_MODIFIED_BROWN_CONRADY, DIST_INVERSE_BROWN_CONRADY):
        x, y = _distort(x, y, coeffs)
    uf = torch.round(fma32(x, fx, ppx))
    vf = torch.round(fma32(y, fy, ppy))
    ps = float(point_size)
    valid = (z > 1e-6) & (uf >= -ps) & (uf < camera.width + ps) & (vf >= -ps) & (vf < camera.height + ps)
    return uf, vf, z, valid


def tiles_per_axis(point_size: int, tile: int) -> int:
    """The most tiles of side ``tile`` that ``point_size`` consecutive
    pixels can touch: ceil((point_size - 1) / tile) + 1."""
    return (int(point_size) - 2) // int(tile) + 2


def bin_capacity(n: int, point_size: int, tile: int) -> int:
    """Entries that one frame's bins can need: every point in every tile its
    square can touch.  The kernel's bins are sized from this (never from a
    count read back from the card)."""
    return int(n) * tiles_per_axis(point_size, tile) ** 2


def bin_counts_plain(points, w2c, camera, point_size: int, tile: int,
                     fused_rows: int = FUSED_ROWS["views"]) -> torch.Tensor:
    """The kernel's binning in PyTorch: (F, tiles_y, tiles_x) int64 entries
    of every (frame, tile) bin, a point counted once in every tile that the
    in-frame pixels of its square touch."""
    width, height, ps, tile = int(camera.width), int(camera.height), int(point_size), int(tile)
    tiles_x, tiles_y = -(-width // tile), -(-height // tile)
    half = ps // 2
    out = []
    for m in w2c:
        uf, vf, _, valid = _frame_projection(points, m, camera, ps, fused_rows)
        ui = torch.where(valid, uf, torch.zeros_like(uf)).to(torch.int64)
        vi = torch.where(valid, vf, torch.zeros_like(vf)).to(torch.int64)
        u0, u1 = (ui - half).clamp(min=0), (ui - half + ps - 1).clamp(max=width - 1)
        v0, v1 = (vi - half).clamp(min=0), (vi - half + ps - 1).clamp(max=height - 1)
        ok = valid & (u0 <= u1) & (v0 <= v1)
        tu0, tu1, tv0, tv1 = (t[ok] // tile for t in (u0, u1, v0, v1))
        # +1 on each point's rectangle of tiles, as a 2-D difference array
        diff = torch.zeros((tiles_y + 1) * (tiles_x + 1), dtype=torch.int64, device=points.device)
        one = torch.ones_like(tu0)
        for v, u, sign in ((tv0, tu0, 1), (tv0, tu1 + 1, -1), (tv1 + 1, tu0, -1), (tv1 + 1, tu1 + 1, 1)):
            diff.index_add_(0, v * (tiles_x + 1) + u, sign * one)
        counts = diff.reshape(tiles_y + 1, tiles_x + 1).cumsum(0).cumsum(1)
        out.append(counts[:tiles_y, :tiles_x])
    return torch.stack(out)


def splat_plain(points, colors01, w2c, camera, point_size: int, rgba_u8: bool = True,
                fused_rows: int = FUSED_ROWS["views"]):
    """The same function in PyTorch, frame by frame: ``scatter_reduce_``
    "amin" on the depth, then "amax" on the winners' point indices, then a
    gather.  Returns u8 RGBA (F, H, W, 4), or f32 (rgb (F, H, W, 3), alpha
    (F, H, W))."""
    _check_args(points, colors01, w2c, point_size)
    dev = points.device
    width, height, ps = int(camera.width), int(camera.height), int(point_size)
    drop = width * height
    half = ps // 2
    offs = torch.arange(-half, ps - half, device=dev)
    du, dv = torch.meshgrid(offs, offs, indexing="ij")
    du, dv = du.reshape(-1), dv.reshape(-1)
    k = ps * ps
    index = torch.arange(points.shape[0], device=dev).repeat_interleave(k)
    white_last = torch.cat([colors01, torch.ones((1, 3), dtype=torch.float32, device=dev)])
    rgbs, alphas = [], []
    for m in w2c:
        uf, vf, z, valid = _frame_projection(points, m, camera, ps, fused_rows)
        # invalid points may sit anywhere: pin them inside int range first
        ui = torch.where(valid, uf, torch.zeros_like(uf)).to(torch.int64)
        vi = torch.where(valid, vf, torch.zeros_like(vf)).to(torch.int64)
        uu = (ui[:, None] + du[None, :]).reshape(-1)
        vv = (vi[:, None] + dv[None, :]).reshape(-1)
        zz = z.repeat_interleave(k)
        ok = valid.repeat_interleave(k) & (uu >= 0) & (uu < width) & (vv >= 0) & (vv < height)
        flat = torch.where(ok, vv * width + uu, torch.full_like(uu, drop))  # drop slot at end
        inf = torch.full_like(zz, float("inf"))
        zbuf = torch.full((drop + 1,), float("inf"), dtype=torch.float32, device=dev)
        zbuf.scatter_reduce_(0, flat, torch.where(ok, zz, inf), "amin")
        win = ok & (zz <= zbuf[flat] + 1e-7)
        winner = torch.full((drop + 1,), -1, dtype=torch.int64, device=dev)
        winner.scatter_reduce_(0, torch.where(win, flat, torch.full_like(flat, drop)), index, "amax")
        winner = winner[:drop]
        rgb = white_last[winner]  # winner -1: the white row
        rgbs.append(rgb.reshape(height, width, 3))
        alphas.append((zbuf[:drop] < float("inf")).to(torch.float32).reshape(height, width))
    rgb, alpha = torch.stack(rgbs), torch.stack(alphas)
    if not rgba_u8:
        return rgb, alpha
    rgba = torch.cat([rgb, alpha[..., None]], dim=-1)
    return torch.round(torch.clamp(rgba, 0.0, 1.0) * 255.0).to(torch.uint8)


def splat(points, colors01, w2c, camera, point_size: int, rgba_u8: bool = True,
          fused_rows: int = FUSED_ROWS["views"]):
    """Splat ``points`` (N, 3) f32 world coordinates with ``colors01`` (N, 3)
    f32 into every frame of ``w2c`` (F, 3, 4) f32 world-to-camera matrices
    at ``camera``'s size and intrinsics, the transform's rows rounded as
    ``fused_rows`` says (:data:`FUSED_ROWS`).  Returns u8 RGBA (F, H, W, 4),
    or with ``rgba_u8=False`` f32 (rgb (F, H, W, 3), alpha (F, H, W))."""
    _check_args(points, colors01, w2c, point_size)
    if points.device.type == "cpu":
        return splat_plain(points, colors01, w2c, camera, point_size, rgba_u8, fused_rows)
    if points.device.type != "cuda":
        raise ValueError(f"splat runs on cpu or cuda tensors; got {points.device}")
    dev = points.device
    frames, width, height = w2c.shape[0], int(camera.width), int(camera.height)
    lib = _lib()
    tile = lib.splat_tile_side()
    n_tiles = -(-width // tile) * -(-height // tile)
    capacity = bin_capacity(points.shape[0], point_size, tile)
    counts = torch.empty((frames, n_tiles), dtype=torch.int32, device=dev)
    cursors = torch.empty((frames, n_tiles), dtype=torch.int64, device=dev)
    bins = torch.empty((frames * capacity, 4), dtype=torch.int32, device=dev)  # depth, index, corner
    if rgba_u8:
        rgba = torch.empty((frames, height, width, 4), dtype=torch.uint8, device=dev)
        alpha = None
    else:
        rgba = torch.empty((frames, height, width, 3), dtype=torch.float32, device=dev)
        alpha = torch.empty((frames, height, width), dtype=torch.float32, device=dev)
    intr = (ctypes.c_float * 9)(*_intrinsics(camera))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.splat_forward(
            points.data_ptr(), colors01.data_ptr(), w2c.data_ptr(), points.shape[0], frames,
            width, height, int(point_size), int(camera.model), int(fused_rows), intr,
            counts.data_ptr(), cursors.data_ptr(), bins.data_ptr(), capacity, rgba.data_ptr(),
            alpha.data_ptr() if alpha is not None else None, int(rgba_u8), stream,
        )
    if rc != 0:
        msg = lib.splat_error_string(rc).decode() if rc > 0 else "bad argument"
        raise RuntimeError(f"splat kernel launch failed ({rc}): {msg}")
    splat.launches += 1
    return rgba if rgba_u8 else (rgba, alpha)


splat.launches = 0  # kernel launches since the count was last reset
