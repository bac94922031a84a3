"""Training frames to uint8, ``out = uint8(clamp(x * 255 + 0.5, 0, 255))``:
CUDA kernel wrapper + plain version.

The kernel (``csrc/frames_u8.cu``, hand-written for sm_90a) replaces no TPU
kernel: the JAX package quantises its training frames in numpy on the host
(``stack_datasets``), and the port quantises them on the card, byte-equal to
numpy's float32 arithmetic, into the trainer's uint8 pixel tensor.

:func:`frames_to_u8` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def _lib() -> ctypes.CDLL:
    lib = _build.load("frames_u8")
    fn = lib.frames_to_u8_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]  # src, out, n, stream
        fn.restype = ctypes.c_int
        lib.frames_to_u8_error_string.argtypes = [ctypes.c_int]
        lib.frames_to_u8_error_string.restype = ctypes.c_char_p
    return lib


def frames_to_u8_plain(src: torch.Tensor) -> torch.Tensor:
    """The same function in float32 PyTorch: the product and the sum each
    rounded, as numpy's ``np.clip(x * 255.0 + 0.5, 0, 255).astype(np.uint8)``."""
    return (src * 255.0 + 0.5).clamp_(0, 255).to(torch.uint8)


def _check_args(src: torch.Tensor, out: torch.Tensor) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if src.dtype != torch.float32 or out.dtype != torch.uint8:
        raise ValueError(f"frames_to_u8 needs a float32 source and a uint8 destination; got {src.dtype}, {out.dtype}")
    if src.dim() != 4 or src.shape[3] != 4 or src.shape != out.shape:
        raise ValueError(
            f"source and destination must both be (F, H, W, 4); got {tuple(src.shape)}, {tuple(out.shape)}"
        )
    if not (src.is_contiguous() and out.is_contiguous()):
        raise ValueError("source and destination must be contiguous")
    if src.device != out.device:
        raise ValueError(f"source on {src.device} but destination on {out.device}")


def frames_to_u8(src: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Quantise float32 frames ``src`` (F, H, W, 4) into the uint8 ``out`` of
    the same shape, in place; returns ``out``.  An empty source launches
    nothing."""
    _check_args(src, out)
    if src.numel() == 0:
        return out
    if src.device.type == "cpu":
        return out.copy_(frames_to_u8_plain(src))
    if src.device.type != "cuda":
        raise ValueError(f"frames_to_u8 runs on cpu or cuda tensors; got {src.device}")
    lib = _lib()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.frames_to_u8_forward(src.data_ptr(), out.data_ptr(), src.numel(), stream)
    if rc != 0:
        msg = lib.frames_to_u8_error_string(rc).decode() if rc > 0 else "bad argument"
        raise RuntimeError(f"frames_to_u8 kernel launch failed ({rc}): {msg}")
    frames_to_u8.launches += 1
    return out


frames_to_u8.launches = 0  # kernel launches since the count was last reset
