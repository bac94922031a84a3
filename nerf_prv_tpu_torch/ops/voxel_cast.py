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
# the kernel's step interval (``step_interval``): steps added at each end,
# and the widening of the grid's box per unit of the magnitudes the f32
# sample adds up
MARGIN_STEPS = 2
BOX_SLACK = 2.0 ** -20


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
    (r,), the voxel of every step clipped into the grid (r, S, 3), whether
    each step's sample lies inside the grid (r, S))."""
    dev = occ.device
    go = torch.tensor([float(np.float32(v)) for v in grid_origin], dtype=torch.float32, device=dev)
    res = float(np.float32(res))
    dims = torch.tensor(occ.shape, dtype=torch.int64, device=dev)
    ts = (torch.arange(int(n_steps), dtype=torch.float32, device=dev) + 0.5) * _step(max_range, n_steps)
    for lo in range(0, origins.shape[0], chunk):
        o, d = origins[lo:lo + chunk], dirs[lo:lo + chunk]
        d = d / _norm(d)[:, None]
        pos = o[:, None, :] + d[:, None, :] * ts[None, :, None]  # (r, S, 3)
        idx = torch.floor((pos - go) / res).to(torch.int64)
        inside = ((idx >= 0) & (idx < dims)).all(dim=-1)
        cidx = torch.minimum(torch.clamp(idx, min=0), dims - 1)
        hit = occ[cidx[..., 0], cidx[..., 1], cidx[..., 2]] & inside  # (r, S)
        yield hit.any(dim=1), hit.to(torch.uint8).argmax(dim=1), cidx, inside


def _norm(d):
    return torch.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])


def step_interval(dims, grid_origin, res, origins, dirs, max_range, n_steps):
    """The kernel's step interval, op for op: (lo (R,), hi (R,)) int64 such
    that every step whose f32 sample floors inside the grid ``dims`` lies in
    [lo, hi] (lo > hi: no step does).  A slab test, in float64, of each
    normalised ray against the grid's box widened per axis by BOX_SLACK of
    the magnitudes the f32 sample adds up, then MARGIN_STEPS more steps at
    each end; an axis the ray does not move along takes step 0's voxel.
    A ray with a non-finite origin or normalised direction gets no step:
    its samples' NaN or infinite coordinates floor outside the grid."""
    dev = origins.device
    step = _step(max_range, n_steps)
    res32 = float(np.float32(res))
    go32 = [float(np.float32(v)) for v in grid_origin]
    d = dirs / _norm(dirs)[:, None]
    t0 = float(np.float32(0.5) * np.float32(step))
    t_end = float(n_steps) * step
    t_lo = torch.zeros(origins.shape[0], dtype=torch.float64, device=dev)
    t_hi = torch.full_like(t_lo, t_end)
    meets = torch.ones(origins.shape[0], dtype=torch.bool, device=dev)
    for a in range(3):
        o, da, dim = origins[:, a], d[:, a], int(dims[a])
        flat = da == 0
        k = torch.floor(((o + da * t0) - go32[a]) / res32)
        meets &= ~flat | ((k >= 0) & (k < dim))
        o64, d64 = o.double(), torch.where(flat, torch.ones_like(da), da).double()
        gap = go32[a] - o64
        eps = BOX_SLACK * (((o64.abs() + abs(go32[a])) + t_end) / res32 + dim + 1.0)
        ta = ((-eps) * res32 + gap) / d64
        tb = ((dim + eps) * res32 + gap) / d64
        t_lo = torch.where(flat, t_lo, torch.maximum(t_lo, torch.minimum(ta, tb)))
        t_hi = torch.where(flat, t_hi, torch.minimum(t_hi, torch.maximum(ta, tb)))
    meets &= t_lo <= t_hi
    lo = torch.clamp(torch.ceil(t_lo / step - 0.5) - MARGIN_STEPS, min=0.0)
    hi = torch.clamp(torch.floor(t_hi / step - 0.5) + MARGIN_STEPS, max=n_steps - 1.0)
    lo = torch.where(meets, lo, torch.zeros_like(lo)).to(torch.int64)
    hi = torch.where(meets, hi, torch.full_like(hi, -1.0)).to(torch.int64)
    if not step > 0:
        lo, hi = torch.zeros_like(lo), torch.full_like(hi, int(n_steps) - 1)
    finite = torch.isfinite(origins).all(dim=1) & torch.isfinite(d).all(dim=1)
    lo = torch.where(finite, lo, torch.zeros_like(lo))
    hi = torch.where(finite, hi, torch.full_like(hi, -1))
    return lo, hi


def voxel_cast_plain(occ, col, grid_origin, res, origins, dirs, max_range, n_steps,
                     chunk: int = PLAIN_CHUNK_RAYS):
    """The reference's materialised march in PyTorch (:func:`march_chunks`).
    Returns (hit (R,) bool, pos (R, 3) f32, col (R, 3) f32)."""
    _check_args(occ, col, grid_origin, origins, dirs, n_steps)
    dev = occ.device
    go = torch.tensor([float(np.float32(v)) for v in grid_origin], dtype=torch.float32, device=dev)
    res32 = float(np.float32(res))
    hits, poss, cols = [], [], []
    for any_hit, first, cidx, _ in march_chunks(occ, grid_origin, res, origins, dirs, max_range, n_steps, chunk):
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
