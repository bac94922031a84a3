"""ResNet-50/101 encoders in PyTorch, written without torchvision.

Counterpart of ``nerf_prv_tpu/prvnet/resnet.py``: the torchvision-layout
bottleneck ResNet with torchvision's parameter names (``conv1``, ``bn1``,
``layer{i}.{j}.conv{1,2,3}`` / ``bn{1,2,3}`` / ``downsample.{0,1}``, ``fc``),
so that a torchvision checkpoint loads with ``load_state_dict`` and the JAX
package's ``convert_resnet_state_dict`` maps every key.  BatchNorm is
:class:`FrozenBN`, as in the reference: ``scale / sqrt(var + eps)`` as an
affine map over the checkpoint's running statistics, whose names are
torchvision's (``weight``, ``bias``, ``running_mean``, ``running_var``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F


class FrozenBN(nn.Module):
    """BatchNorm as a learnable affine map over running statistics."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.running_mean = nn.Parameter(torch.zeros(dim))
        self.running_var = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):  # (N, C, H, W)
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


class Bottleneck(nn.Module):
    """torchvision Bottleneck (expansion 4)."""

    def __init__(self, in_dim: int, width: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_dim, width, 1, bias=False)
        self.bn1 = FrozenBN(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBN(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = FrozenBN(width * 4)
        self.downsample = (
            nn.Sequential(nn.Conv2d(in_dim, width * 4, 1, stride=stride, bias=False), FrozenBN(width * 4))
            if downsample
            else None
        )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(out + x)


class ResNet(nn.Module):
    """torchvision-layout bottleneck ResNet; (N, 3, H, W) -> (N, num_classes)."""

    def __init__(self, depths: Sequence[int] = (3, 4, 6, 3), num_classes: int = 1000):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBN(64)
        in_dim, width = 64, 64
        for i, depth in enumerate(depths):
            blocks = []
            for j in range(depth):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(Bottleneck(in_dim, width, stride=stride, downsample=j == 0))
                in_dim = width * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            width *= 2
        self.n_layers = len(depths)
        self.fc = nn.Linear(in_dim, num_classes)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        # flax's max_pool pads with -inf, as torch's does
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i + 1}")(x)
        return self.fc(x.mean(dim=(2, 3)))


def resnet50(**kw):
    return ResNet(depths=(3, 4, 6, 3), **kw)


def resnet101(**kw):
    return ResNet(depths=(3, 4, 23, 3), **kw)
