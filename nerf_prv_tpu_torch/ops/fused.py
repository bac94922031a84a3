"""Fused encode: the CUDA hash-encode forward with the CUDA table gradient.

Counterpart of ``nerf_prv_tpu/ops/fused.py`` (Pallas forward, sort-based
backward).  Here both directions are kernels on CUDA tensors
(:func:`~.hash_encode.hash_encode`, :func:`~.hash_encode.hash_encode_backward`)
and their plain versions on CPU tensors.
"""

from __future__ import annotations

import torch

from ..nerf.hashgrid import HashGridConfig
from .hash_encode import hash_encode, hash_encode_backward


class _EncodeFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, x, cfg):
        ctx.save_for_backward(x)
        ctx.cfg = cfg
        return hash_encode(table, x, cfg)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return hash_encode_backward(x, g.contiguous(), ctx.cfg), None, None


def encode_fused(table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """Hash encoding through the fused kernels; positions are
    non-differentiable (the pipeline never backpropagates into camera
    geometry)."""
    return _EncodeFused.apply(table, x.detach(), cfg)
