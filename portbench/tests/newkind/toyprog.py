"""A toy program: ``toy_axpy(a, x, y)``, a*x + y, one Triton kernel on the
card (``toyprog_kernel.toy_axpy_kernel``, imported at the first launch) and
PyTorch on the CPU.  It counts its calls in ``toy_axpy.launches``, as the
port's kernel wrappers count their launches."""

import importlib

import torch

BLOCK = 1024


def toy_axpy(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    toy_axpy.launches += 1
    if x.device.type != "cuda":
        return a * x + y
    out = torch.empty_like(y)
    n = out.numel()
    kernel = importlib.import_module("toyprog_kernel").toy_axpy_kernel
    kernel[((n + BLOCK - 1) // BLOCK,)](x, y, out, a, n, BLOCK=BLOCK)
    return out


toy_axpy.launches = 0  # launches since the count was last reset
