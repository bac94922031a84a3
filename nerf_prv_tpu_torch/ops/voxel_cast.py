"""Occupancy ray cast (K9): CUDA kernel wrapper + plain version.

The kernel (``csrc/voxel_cast.cu``, hand-written for sm_90a) replaces
``nerf_prv_tpu/scene/voxel.py::_cast_rays_grid``, which the reference
computes with XLA ops (no Pallas kernel): a fixed-step march of each ray to
the first occupied voxel of a dense grid, returning the hit flag, the
voxel's centre and its colour.  A ray that hits nothing reports step 0's
voxel clipped into the grid, as the reference's ``argmax`` of an all-false
row does.

:func:`voxel_cast` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# rays per chunk of the plain version: it materialises every (ray, step)
# sample, 1,000 steps x 3 floats a ray at the 2 mm grid
PLAIN_CHUNK_RAYS = 1 << 12


def _lib() -> ctypes.CDLL:
    return bind(_build.load("voxel_cast"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures on a build of ``csrc/voxel_cast.cu``."""
    fn = lib.voxel_cast_forward
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),  # occ, col, grid
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dims, n_steps
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # origins, dirs, n_rays
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # hit, pos, color
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.voxel_cast_error_string.argtypes = [ctypes.c_int]
        lib.voxel_cast_error_string.restype = ctypes.c_char_p
    return lib


def _step(max_range: float, n_steps: int) -> float:
    """max_range / n_steps in f32, as the reference divides its f32 range."""
    return float(np.float32(max_range) / np.float32(n_steps))


def _check_args(occ, col, grid_origin, origins, dirs, n_steps) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if occ.dtype != torch.bool or occ.dim() != 3 or min(occ.shape) == 0:
        raise ValueError(f"occ must be a non-empty (D0, D1, D2) bool grid; got {occ.dtype} {tuple(occ.shape)}")
    if col.dtype != torch.float32 or tuple(col.shape) != (*occ.shape, 3):
        raise ValueError(f"col must be (D0, D1, D2, 3) float32; got {col.dtype} {tuple(col.shape)}")
    for name, t in (("origins", origins), ("dirs", dirs)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be (R, 3) float32; got {t.dtype} {tuple(t.shape)}")
    if origins.shape != dirs.shape or len(grid_origin) != 3 or int(n_steps) < 1:
        raise ValueError("origins and dirs must match, grid_origin have 3 values, n_steps be >= 1")
    for t in (occ, col, origins, dirs):
        if not t.is_contiguous():
            raise ValueError("voxel_cast needs contiguous tensors")
        if t.device != occ.device:
            raise ValueError(f"a tensor on {t.device} but occ on {occ.device}")


def march_chunks(occ, grid_origin, res, origins, dirs, max_range, n_steps, chunk: int = PLAIN_CHUNK_RAYS):
    """The reference's materialised march, ``chunk`` rays at a time, in the
    kernel's order of f32 operations: yields (any hit (r,), first hit step
    (r,), the voxel of every step clipped into the grid (r, S, 3))."""
    dev = occ.device
    go = torch.tensor([float(np.float32(v)) for v in grid_origin], dtype=torch.float32, device=dev)
    res = float(np.float32(res))
    dims = torch.tensor(occ.shape, dtype=torch.int64, device=dev)
    ts = (torch.arange(int(n_steps), dtype=torch.float32, device=dev) + 0.5) * _step(max_range, n_steps)
    for lo in range(0, origins.shape[0], chunk):
        o, d = origins[lo:lo + chunk], dirs[lo:lo + chunk]
        norm = torch.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
        d = d / norm[:, None]
        pos = o[:, None, :] + d[:, None, :] * ts[None, :, None]  # (r, S, 3)
        idx = torch.floor((pos - go) / res).to(torch.int64)
        inside = ((idx >= 0) & (idx < dims)).all(dim=-1)
        cidx = torch.minimum(torch.clamp(idx, min=0), dims - 1)
        hit = occ[cidx[..., 0], cidx[..., 1], cidx[..., 2]] & inside  # (r, S)
        yield hit.any(dim=1), hit.to(torch.uint8).argmax(dim=1), cidx


def voxel_cast_plain(occ, col, grid_origin, res, origins, dirs, max_range, n_steps,
                     chunk: int = PLAIN_CHUNK_RAYS):
    """The reference's materialised march in PyTorch (:func:`march_chunks`).
    Returns (hit (R,) bool, pos (R, 3) f32, col (R, 3) f32)."""
    _check_args(occ, col, grid_origin, origins, dirs, n_steps)
    dev = occ.device
    go = torch.tensor([float(np.float32(v)) for v in grid_origin], dtype=torch.float32, device=dev)
    res32 = float(np.float32(res))
    hits, poss, cols = [], [], []
    for any_hit, first, cidx in march_chunks(occ, grid_origin, res, origins, dirs, max_range, n_steps, chunk):
        hit_idx = cidx[torch.arange(cidx.shape[0], device=dev), first]
        hits.append(any_hit)
        poss.append((hit_idx.to(torch.float32) + 0.5) * res32 + go)
        cols.append(col[hit_idx[:, 0], hit_idx[:, 1], hit_idx[:, 2]])
    if not hits:
        empty = torch.zeros((0, 3), dtype=torch.float32, device=dev)
        return torch.zeros((0,), dtype=torch.bool, device=dev), empty, empty.clone()
    return torch.cat(hits), torch.cat(poss), torch.cat(cols)


def voxel_cast(occ, col, grid_origin, res, origins, dirs, max_range, n_steps):
    """March rays (``origins``, ``dirs``: (R, 3) f32) through the dense grid
    ``occ`` (D0, D1, D2) bool with colours ``col`` (D0, D1, D2, 3) f32 and
    corner ``grid_origin`` at voxel size ``res``, ``n_steps`` fixed steps
    over ``max_range``.  Returns (hit (R,) bool, pos (R, 3), col (R, 3))."""
    _check_args(occ, col, grid_origin, origins, dirs, n_steps)
    if occ.device.type == "cpu":
        return voxel_cast_plain(occ, col, grid_origin, res, origins, dirs, max_range, n_steps)
    if occ.device.type != "cuda":
        raise ValueError(f"voxel_cast runs on cpu or cuda tensors; got {occ.device}")
    n = origins.shape[0]
    dev = occ.device
    hit = torch.empty((n,), dtype=torch.bool, device=dev)
    pos = torch.empty((n, 3), dtype=torch.float32, device=dev)
    color = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return hit, pos, color
    grid = (ctypes.c_float * 5)(*[float(np.float32(v)) for v in grid_origin], float(np.float32(res)),
                                _step(max_range, n_steps))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.voxel_cast_forward(
            occ.data_ptr(), col.data_ptr(), grid, *occ.shape, int(n_steps),
            origins.data_ptr(), dirs.data_ptr(), n, hit.data_ptr(), pos.data_ptr(), color.data_ptr(), stream,
        )
    if rc != 0:
        msg = lib.voxel_cast_error_string(rc).decode() if rc > 0 else "bad argument"
        raise RuntimeError(f"voxel_cast kernel launch failed ({rc}): {msg}")
    voxel_cast.launches += 1
    return hit, pos, color


voxel_cast.launches = 0  # kernel launches since the count was last reset
