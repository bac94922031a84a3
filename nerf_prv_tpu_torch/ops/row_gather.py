"""Row gather ``out[i] = table[idx[i]]``: CUDA kernel wrapper + plain version.

The kernel (``csrc/row_gather.cu``, hand-written for sm_90a) replaces the
Pallas ``_gather_kernel`` of ``experiments/exp_vmem_gather.py``.  The voxel
field gathers one wide grid row per sample through it, and the render
probe one 16-byte row of corner densities per probe sample.

:func:`row_gather` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_TABLE_DTYPES = (torch.float32, torch.bfloat16)
_INDEX_DTYPES = (torch.int32, torch.int64)


def _lib() -> ctypes.CDLL:
    lib = _build.load("row_gather")
    fn = lib.row_gather_forward
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # table, idx, out
            ctypes.c_int64, ctypes.c_int, ctypes.c_int,  # n, row bytes, idx is int64
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.row_gather_error_string.argtypes = [ctypes.c_int]
        lib.row_gather_error_string.restype = ctypes.c_char_p
    return lib


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The same function by PyTorch's own indexing."""
    return table[idx.to(torch.int64)]


def _check_args(table: torch.Tensor, idx: torch.Tensor) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if table.dtype not in _TABLE_DTYPES:
        raise ValueError(f"row_gather needs a float32 or bfloat16 table; got {table.dtype}")
    if idx.dtype not in _INDEX_DTYPES:
        raise ValueError(f"row_gather needs int32 or int64 indices; got {idx.dtype}")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(
            f"table must be (R, W) and idx (N,); got {tuple(table.shape)}, {tuple(idx.shape)}"
        )
    if table.shape[0] == 0 or table.shape[1] == 0 or table.shape[1] % 4:
        raise ValueError(
            f"table needs rows and a width that is a multiple of 4; got {tuple(table.shape)}"
        )
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if table.device != idx.device:
        raise ValueError(f"table on {table.device} but idx on {idx.device}")


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (R, W) float32 or bfloat16, idx (N,) int -> (N, W) in the
    table's dtype.  Indices are not clamped: one outside ``[0, R)`` is the
    caller's fault."""
    _check_args(table, idx)
    if table.device.type == "cpu":
        return row_gather_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"row_gather runs on cpu or cuda tensors; got {table.device}")
    n, width = idx.shape[0], table.shape[1]
    out = torch.empty((n, width), dtype=table.dtype, device=table.device)
    if n == 0:
        return out
    row_bytes = width * table.element_size()
    # a row moves as 16-byte vectors, or 8-byte ones where 16 does not divide it
    align = 16 if row_bytes % 16 == 0 else 8
    if table.data_ptr() % align or out.data_ptr() % align:
        raise ValueError(f"table storage is not aligned to {align} bytes")
    lib = _lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.row_gather_forward(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(),
            n, row_bytes, int(idx.dtype == torch.int64), stream,
        )
    if rc != 0:
        msg = lib.row_gather_error_string(rc).decode() if rc > 0 else "bad argument"
        raise RuntimeError(f"row_gather kernel launch failed ({rc}): {msg}")
    row_gather.launches += 1
    return out


row_gather.launches = 0  # kernel launches since the count was last reset
