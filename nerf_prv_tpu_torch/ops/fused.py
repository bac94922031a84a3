"""Fused encode: the CUDA hash-encode forward (forward only for now).

Counterpart of ``nerf_prv_tpu/ops/fused.py``, whose backward is the
sort-based table gradient; the port's backward comes with training.
"""

from __future__ import annotations

import torch

from ..nerf.hashgrid import HashGridConfig
from .hash_encode import hash_encode


def encode_fused(table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """Hash encoding through the fused kernel; positions are non-differentiable.

    Raises NotImplementedError where autograd would need the table
    gradient, rather than silently returning a detached result.
    """
    if table.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "encode_fused has no backward yet; call it under torch.no_grad()"
        )
    return hash_encode(table, x, cfg)
