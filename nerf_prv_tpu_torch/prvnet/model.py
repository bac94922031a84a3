"""PVBNet / PVBPretrain — the view-budget regression heads, in PyTorch.

Counterpart of ``nerf_prv_tpu/prvnet/model.py``: one encoder applied to K
input views; PVBNet pools by concat(mean, unbiased variance) over the view
axis into a 2000-d vector, then five activation-free Linear layers down to
one logit; PVBPretrain is the single-view variant.  The logit maps to the
view budget through ``min + (max - min) * sigmoid``.

Views come in NHWC, as the JAX module takes them, and are permuted to NCHW
for the encoder.  The head is ``fc_layer``, an ``nn.Sequential`` whose
``fc_layer.{i}`` keys are the reference checkpoint's and map to the JAX
tree's ``fc{i}``; PVBPretrain's index 0 is an ``nn.Identity`` (the encoder's
1000-d output stands in for ``fc0``), so its Linears are ``fc_layer.1..4``,
the JAX tree's ``fc1..fc4``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def _fc_layer(in_dim: int, fc_dims: Sequence[int], skip_first: bool) -> nn.Sequential:
    """Linears through ``fc_dims`` (no activations, as the reference);
    with ``skip_first`` index 0 is an Identity and ``in_dim`` feeds index 1."""
    dims = [in_dim] + list(fc_dims[1:]) if skip_first else [in_dim] + list(fc_dims)
    layers = [nn.Identity()] if skip_first else []
    layers += [nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])]
    return nn.Sequential(*layers)


class PVBNet(nn.Module):
    """K-view budget regressor: (N, K, H, W, 3) -> (N,) logits."""

    def __init__(self, encoder: nn.Module, num_classes: int = 1000, fc_dims: Sequence[int] = (1000, 500, 250, 100, 1)):
        super().__init__()
        self.encoder = encoder
        self.fc_layer = _fc_layer(2 * num_classes, fc_dims, skip_first=False)

    def forward(self, views):
        n, k = views.shape[0], views.shape[1]
        flat = views.reshape((n * k,) + tuple(views.shape[2:])).permute(0, 3, 1, 2)
        enc = self.encoder(flat).reshape(n, k, -1)
        x = torch.cat([enc.mean(dim=1), enc.var(dim=1, correction=1)], dim=-1)
        return self.fc_layer(x)[..., 0]


class PVBPretrain(nn.Module):
    """Single-view variant: (N, H, W, 3) -> (N,) logits."""

    def __init__(self, encoder: nn.Module, num_classes: int = 1000, fc_dims: Sequence[int] = (1000, 500, 250, 100, 1)):
        super().__init__()
        self.encoder = encoder
        self.fc_layer = _fc_layer(num_classes, fc_dims, skip_first=True)

    def forward(self, views):
        return self.fc_layer(self.encoder(views.permute(0, 3, 1, 2)))[..., 0]


def make_pvbnet(arch: str = "convnextv2_tiny", num_classes: int = 1000) -> PVBNet:
    from .convnextv2 import MODELS

    return PVBNet(MODELS[arch](num_classes=num_classes), num_classes=num_classes)


def make_pvbpretrain(arch: str = "convnextv2_tiny", num_classes: int = 1000) -> PVBPretrain:
    from .convnextv2 import MODELS

    return PVBPretrain(MODELS[arch](num_classes=num_classes), num_classes=num_classes)


def logits_to_budget(logits, min_label: int = 13, max_label: int = 58):
    """Sigmoid-rescaled prediction."""
    return min_label + (max_label - min_label) * torch.sigmoid(torch.as_tensor(logits))


IMG_PATTERN = [
    [1],
    [0, 1],
    [0, 1, 3],
    [0, 1, 2, 3],
    [0, 1, 2, 3, 4],
]
