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

:func:`splat` takes the plain version only for tensors on the CPU.  For
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

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
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),  # point size, model, intr
            ctypes.c_void_p, ctypes.c_void_p,  # zbuf, winner
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # rgba, alpha, out_u8
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
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


def _frame_projection(points, m, camera, point_size):
    """Pixel (float, rounded), depth and validity of every point in the frame
    of the (3, 4) world-to-camera matrix ``m``, in the kernel's order of f32
    operations (never a matmul, whose summation order is its own)."""
    from ..core.camera import DIST_INVERSE_BROWN_CONRADY, DIST_MODIFIED_BROWN_CONRADY, _distort_brown_conrady

    p0, p1, p2 = points[:, 0], points[:, 1], points[:, 2]
    xc = ((p0 * m[0, 0] + p1 * m[0, 1]) + p2 * m[0, 2]) + m[0, 3]
    yc = ((p0 * m[1, 0] + p1 * m[1, 1]) + p2 * m[1, 2]) + m[1, 3]
    z = ((p0 * m[2, 0] + p1 * m[2, 1]) + p2 * m[2, 2]) + m[2, 3]
    zd = torch.clamp(z, min=1e-9)
    x, y = xc / zd, yc / zd
    fx, fy, ppx, ppy, *coeffs = _intrinsics(camera)
    if int(camera.model) in (DIST_MODIFIED_BROWN_CONRADY, DIST_INVERSE_BROWN_CONRADY):
        x, y = _distort_brown_conrady(x, y, coeffs)
    uf = torch.round(x * fx + ppx)
    vf = torch.round(y * fy + ppy)
    ps = float(point_size)
    valid = (z > 1e-6) & (uf >= -ps) & (uf < camera.width + ps) & (vf >= -ps) & (vf < camera.height + ps)
    return uf, vf, z, valid


def splat_plain(points, colors01, w2c, camera, point_size: int, rgba_u8: bool = True):
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
    rgbs, alphas = [], []
    for m in w2c:
        uf, vf, z, valid = _frame_projection(points, m, camera, ps)
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
        rgb = torch.where((winner >= 0)[:, None], colors01[winner.clamp(min=0)],
                          torch.ones((), dtype=torch.float32, device=dev))
        rgbs.append(rgb.reshape(height, width, 3))
        alphas.append((zbuf[:drop] < float("inf")).to(torch.float32).reshape(height, width))
    rgb, alpha = torch.stack(rgbs), torch.stack(alphas)
    if not rgba_u8:
        return rgb, alpha
    rgba = torch.cat([rgb, alpha[..., None]], dim=-1)
    return torch.round(torch.clamp(rgba, 0.0, 1.0) * 255.0).to(torch.uint8)


def splat(points, colors01, w2c, camera, point_size: int, rgba_u8: bool = True):
    """Splat ``points`` (N, 3) f32 world coordinates with ``colors01`` (N, 3)
    f32 into every frame of ``w2c`` (F, 3, 4) f32 world-to-camera matrices
    at ``camera``'s size and intrinsics.  Returns u8 RGBA (F, H, W, 4), or
    with ``rgba_u8=False`` f32 (rgb (F, H, W, 3), alpha (F, H, W))."""
    _check_args(points, colors01, w2c, point_size)
    if points.device.type == "cpu":
        return splat_plain(points, colors01, w2c, camera, point_size, rgba_u8)
    if points.device.type != "cuda":
        raise ValueError(f"splat runs on cpu or cuda tensors; got {points.device}")
    dev = points.device
    frames, width, height = w2c.shape[0], int(camera.width), int(camera.height)
    zbuf = torch.empty((frames, height, width), dtype=torch.int32, device=dev)
    winner = torch.empty((frames, height, width), dtype=torch.int32, device=dev)
    if rgba_u8:
        rgba = torch.empty((frames, height, width, 4), dtype=torch.uint8, device=dev)
        alpha = None
    else:
        rgba = torch.empty((frames, height, width, 3), dtype=torch.float32, device=dev)
        alpha = torch.empty((frames, height, width), dtype=torch.float32, device=dev)
    intr = (ctypes.c_float * 9)(*_intrinsics(camera))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.splat_forward(
            points.data_ptr(), colors01.data_ptr(), w2c.data_ptr(), points.shape[0], frames,
            width, height, int(point_size), int(camera.model), intr,
            zbuf.data_ptr(), winner.data_ptr(), rgba.data_ptr(),
            alpha.data_ptr() if alpha is not None else None, int(rgba_u8), stream,
        )
    if rc != 0:
        msg = lib.splat_error_string(rc).decode() if rc > 0 else "bad argument"
        raise RuntimeError(f"splat kernel launch failed ({rc}): {msg}")
    splat.launches += 1
    return rgba if rgba_u8 else (rgba, alpha)


splat.launches = 0  # kernel launches since the count was last reset
