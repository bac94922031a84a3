"""Fused multiresolution hash encoding: CUDA kernel wrapper + plain version.

Counterpart of ``nerf_prv_tpu/ops/hash_encode.py``.  The kernel
(``csrc/hash_encode.cu``, hand-written for sm_90a) replaces the Pallas
``_encode_kernel``; its plain PyTorch version is
:func:`nerf_prv_tpu_torch.nerf.hashgrid.encode`, which the kernel
reproduces, dense-or-hashed level choice included.

:func:`hash_encode` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..nerf.hashgrid import HashGridConfig, encode, is_dense
from . import _build

_FEATURES = (1, 2, 4, 8)
_MAX_LEVELS = 32


def level_plan(cfg: HashGridConfig) -> tuple:
    """(resolutions, dense flags) per level as the kernel takes them.

    The dense-or-hashed choice is made here, in Python integers: in 32 bits
    (res + 1)^3 wraps from level 14 of the default config on.
    """
    res = [int(r) for r in cfg.resolutions()]
    return res, [int(is_dense(r, cfg.table_size)) for r in res]


@functools.lru_cache(maxsize=None)
def _level_arrays(cfg: HashGridConfig) -> tuple:
    """``level_plan`` as the C arrays a launch passes, made once per config
    (a handful exist in a process; a launch only reads them)."""
    res, dense = level_plan(cfg)
    return (ctypes.c_int * cfg.levels)(*res), (ctypes.c_int * cfg.levels)(*dense)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``hash_encode`` library."""
    fn = lib.hash_encode_forward
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, table, out
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.hash_encode_error_string.argtypes = [ctypes.c_int]
        lib.hash_encode_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    return bind(_build.load("hash_encode"))


def _check_args(table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if x.dtype != torch.float32 or table.dtype != torch.float32:
        raise ValueError(
            f"hash_encode needs float32 x and table; got {x.dtype}, {table.dtype}"
        )
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be (N, 3); got {tuple(x.shape)}")
    want = (cfg.levels * cfg.table_size, cfg.features)
    if tuple(table.shape) != want:
        raise ValueError(f"table must be {want} for {cfg}; got {tuple(table.shape)}")
    if cfg.features not in _FEATURES:
        raise ValueError(f"features must be one of {_FEATURES}; got {cfg.features}")
    if not 1 <= cfg.levels <= _MAX_LEVELS or cfg.log2_table > 31:
        raise ValueError(f"at most {_MAX_LEVELS} levels and 2^31 rows; got {cfg}")
    if not (x.is_contiguous() and table.is_contiguous()):
        raise ValueError("x and table must be contiguous")
    if x.device != table.device:
        raise ValueError(f"x on {x.device} but table on {table.device}")


def hash_encode(table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """x (N, 3) in [0,1]^3 -> features (N, levels*features), float32."""
    _check_args(table, x, cfg)
    if x.device.type == "cpu":
        return encode(table, x, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"hash_encode runs on cpu or cuda tensors; got {x.device}")
    n = x.shape[0]
    out = torch.empty((n, cfg.out_dim), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    # rows are loaded as vectors of up to 16 bytes and the output is stored
    # as 16-byte vectors
    if table.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("table storage is not aligned to 16 bytes")
    lib = _lib()
    res_arr, dense_arr = _level_arrays(cfg)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hash_encode_forward(
            x.data_ptr(), table.data_ptr(), out.data_ptr(),
            n, cfg.levels, cfg.table_size, cfg.features,
            res_arr, dense_arr, stream,
        )
    if rc != 0:
        msg = lib.hash_encode_error_string(rc).decode() if rc > 0 else "bad argument"
        raise RuntimeError(f"hash_encode kernel launch failed ({rc}): {msg}")
    hash_encode.launches += 1
    return out


hash_encode.launches = 0  # kernel launches since the count was last reset
