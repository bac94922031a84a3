"""Row scatter-add ``out[idx[i]] += upd[i]`` from zeros: CUDA kernel wrapper
+ plain version.

The kernel (``csrc/row_scatter_add.cu``, hand-written for sm_90a) replaces
the Pallas kernels of ``experiments/exp_scatter_kernel.py``,
``experiments/exp_scatter_banks.py`` and the scatter of
``experiments/exp_vmem_gather.py``, which all compute this sum.  It is the
backward of the voxel field's row gather.

The kernel adds with atomics in no fixed order, so a row that receives
several updates differs from run to run in its last bits: compare within a
tolerance, never exactly.

:func:`row_scatter_add` takes the plain version only for tensors on the
CPU.  For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_INDEX_DTYPES = (torch.int32, torch.int64)


def _lib() -> ctypes.CDLL:
    lib = _build.load("row_scatter_add")
    fn = lib.row_scatter_add_forward
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # idx, upd, out
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,  # n, rows, width, idx is int64
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.row_scatter_add_error_string.argtypes = [ctypes.c_int]
        lib.row_scatter_add_error_string.restype = ctypes.c_char_p
    return lib


def row_scatter_add_plain(idx: torch.Tensor, upd: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The same function by PyTorch's own ``index_add_``."""
    out = torch.zeros((n_rows, upd.shape[1]), dtype=upd.dtype, device=upd.device)
    return out.index_add_(0, idx, upd)


def _check_args(idx: torch.Tensor, upd: torch.Tensor, n_rows: int) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if upd.dtype != torch.float32:
        raise ValueError(f"row_scatter_add needs float32 updates; got {upd.dtype}")
    if idx.dtype not in _INDEX_DTYPES:
        raise ValueError(f"row_scatter_add needs int32 or int64 indices; got {idx.dtype}")
    if upd.dim() != 2 or idx.dim() != 1 or idx.shape[0] != upd.shape[0]:
        raise ValueError(
            f"idx must be (N,) and upd (N, W); got {tuple(idx.shape)}, {tuple(upd.shape)}"
        )
    if n_rows < 1 or upd.shape[1] == 0 or upd.shape[1] % 4:
        raise ValueError(
            f"need n_rows >= 1 and a width that is a multiple of 4; got {n_rows}, {upd.shape[1]}"
        )
    if not (upd.is_contiguous() and idx.is_contiguous()):
        raise ValueError("idx and upd must be contiguous")
    if upd.device != idx.device:
        raise ValueError(f"upd on {upd.device} but idx on {idx.device}")


def row_scatter_add(idx: torch.Tensor, upd: torch.Tensor, n_rows: int) -> torch.Tensor:
    """idx (N,) int, upd (N, W) float32 -> (n_rows, W) float32, the sum of
    the update rows by index, from zeros.  Indices are not clamped: one
    outside ``[0, n_rows)`` is the caller's fault."""
    _check_args(idx, upd, n_rows)
    if upd.device.type == "cpu":
        return row_scatter_add_plain(idx, upd, n_rows)
    if upd.device.type != "cuda":
        raise ValueError(f"row_scatter_add runs on cpu or cuda tensors; got {upd.device}")
    n, width = upd.shape
    # the kernel zeroes the output itself, on the same stream
    out = torch.empty((n_rows, width), dtype=torch.float32, device=upd.device)
    if out.data_ptr() % 16 or upd.data_ptr() % 16:
        raise ValueError("upd storage is not aligned to 16 bytes")
    lib = _lib()
    with torch.cuda.device(upd.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.row_scatter_add_forward(
            idx.data_ptr(), upd.data_ptr(), out.data_ptr(),
            n, n_rows, width, int(idx.dtype == torch.int64), stream,
        )
    if rc != 0:
        msg = lib.row_scatter_add_error_string(rc).decode() if rc > 0 else "bad argument"
        raise RuntimeError(f"row_scatter_add kernel launch failed ({rc}): {msg}")
    if n:
        row_scatter_add.launches += 1
    return out


row_scatter_add.launches = 0  # kernel launches since the count was last reset
