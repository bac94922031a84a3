"""ctypes bindings for the repo's native C++ IO runtime (``csrc/prv_runtime.cpp``).

The port's own copy of ``nerf_prv_tpu/runtime/native.py``: host-side PLY
parsing, voxel downsampling and the ready-file IPC protocol in C++.  The
library is built by ``make -C csrc`` into ``csrc/libprv_runtime.so``;
where it is missing, :func:`available` is False and callers use their
Python paths.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "csrc", "libprv_runtime.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.prv_ply_open.restype = ctypes.c_void_p
        lib.prv_ply_open.argtypes = [ctypes.c_char_p]
        lib.prv_ply_count.restype = ctypes.c_long
        lib.prv_ply_count.argtypes = [ctypes.c_void_p]
        lib.prv_ply_has_color.restype = ctypes.c_int
        lib.prv_ply_has_color.argtypes = [ctypes.c_void_p]
        lib.prv_ply_read.restype = ctypes.c_int
        lib.prv_ply_read.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.prv_ply_close.argtypes = [ctypes.c_void_p]
        lib.prv_voxel_first_win.restype = ctypes.c_long
        lib.prv_voxel_first_win.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.prv_white_to_alpha.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.prv_poll_file.restype = ctypes.c_int
        lib.prv_poll_file.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_long]
        lib.prv_touch.restype = ctypes.c_int
        lib.prv_touch.argtypes = [ctypes.c_char_p]
        lib.prv_remove.restype = ctypes.c_int
        lib.prv_remove.argtypes = [ctypes.c_char_p]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def load_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime not built")
    handle = lib.prv_ply_open(path.encode())
    if not handle:
        raise OSError(f"native ply parse failed: {path}")
    try:
        n = lib.prv_ply_count(handle)
        has_color = bool(lib.prv_ply_has_color(handle))
        pts = np.empty((n, 3), dtype=np.float64)
        cols = np.empty((n, 3), dtype=np.uint8) if has_color else np.empty((0, 3), np.uint8)
        rc = lib.prv_ply_read(
            handle,
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc != 0:
            raise OSError(f"native ply read failed rc={rc}: {path}")
        return pts, (cols if has_color else None)
    finally:
        lib.prv_ply_close(handle)


def voxel_first_win(points: np.ndarray, resolution: float) -> np.ndarray:
    """Indices of the first point per occupied voxel (native fast path)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime not built")
    pts = np.ascontiguousarray(points, dtype=np.float64)
    keep = np.empty(len(pts), dtype=np.int64)
    n = lib.prv_voxel_first_win(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(pts),
        float(resolution),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    return keep[:n]


def white_to_alpha(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W, 4) with white pixels transparent."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime not built")
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    rgba = np.empty((h, w, 4), dtype=np.uint8)
    lib.prv_white_to_alpha(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h * w,
        rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return rgba


def poll_file(path: str, interval_ms: int = 100, timeout_ms: int = -1) -> bool:
    """Block until a file exists (native ready-file IPC); True when found."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime not built")
    return lib.prv_poll_file(path.encode(), interval_ms, timeout_ms) == 0


def touch(path: str) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime not built")
    if lib.prv_touch(path.encode()) != 0:
        raise OSError(f"touch failed: {path}")
