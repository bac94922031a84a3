"""ConvNeXt-V2 encoder in PyTorch.

Counterpart of ``nerf_prv_tpu/prvnet/convnextv2.py``: depthwise 7x7 convs,
LayerNorm, a 4x pointwise MLP with exact GELU and Global Response
Normalization, stage dims (96, 192, 384, 768) for tiny.  It computes what
the JAX module computes (GRN's ``1e-12`` inside the root, LayerNorm eps
``1e-6``, global mean, then the head's LayerNorm and the 1000-d head), and
its parameters carry the official ConvNeXt-V2 PyTorch names
(``downsample_layers.{i}.{0,1}``, ``stages.{i}.{j}.*``, ``norm``, ``head``),
so that a reference ``best_checkpoint.pth`` loads with ``load_state_dict``
and ``nerf_prv_tpu/prvnet/infer.py::_convert_encoder_key`` maps every key.

Activations run NCHW through the convs, as upstream does; a block permutes
to NHWC for its LayerNorm and pointwise layers.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel axis of an NCHW tensor (upstream's
    ``LayerNorm(data_format="channels_first")``)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)
        return x.permute(0, 3, 1, 2)


class GRN(nn.Module):
    """Global Response Normalization on NHWC input; ``gamma`` and ``beta``
    are (1, 1, 1, C) as upstream keeps them."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, x):  # (N, H, W, C)
        gx = torch.sqrt(torch.sum(x * x, dim=(1, 2), keepdim=True) + 1e-12)
        nx = gx / (torch.mean(gx, dim=-1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class Block(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, kernel_size=7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.act = nn.GELU(approximate="none")
        self.grn = GRN(4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)

    def forward(self, x):  # (N, C, H, W)
        inp = x
        x = self.dwconv(x).permute(0, 2, 3, 1)
        x = self.pwconv2(self.grn(self.act(self.pwconv1(self.norm(x)))))
        return inp + x.permute(0, 3, 1, 2)


class ConvNeXtV2(nn.Module):
    """``forward`` takes (N, 3, H, W) and returns (N, num_classes) features."""

    def __init__(
        self,
        depths: Sequence[int] = (3, 3, 9, 3),
        dims: Sequence[int] = (96, 192, 384, 768),
        num_classes: int = 1000,
        head_init_scale: float = 0.001,
    ):
        super().__init__()
        self.downsample_layers = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(3, dims[0], kernel_size=4, stride=4), LayerNorm2d(dims[0]))]
            + [
                nn.Sequential(LayerNorm2d(dims[i - 1]), nn.Conv2d(dims[i - 1], dims[i], kernel_size=2, stride=2))
                for i in range(1, len(dims))
            ]
        )
        self.stages = nn.ModuleList(
            [nn.Sequential(*[Block(dim) for _ in range(depth)]) for depth, dim in zip(depths, dims)]
        )
        self.norm = nn.LayerNorm(dims[-1], eps=1e-6)
        self.head = nn.Linear(dims[-1], num_classes)
        self.apply(self._init_weights)
        with torch.no_grad():
            self.head.weight.mul_(head_init_scale)
            self.head.bias.mul_(head_init_scale)

    @staticmethod
    def _init_weights(m):
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.trunc_normal_(m.weight, std=0.02)
            nn.init.zeros_(m.bias)

    def forward(self, x):
        for down, stage in zip(self.downsample_layers, self.stages):
            x = stage(down(x))
        return self.head(self.norm(x.mean(dim=(2, 3))))


def convnextv2_atto(**kw):
    return ConvNeXtV2(depths=(2, 2, 6, 2), dims=(40, 80, 160, 320), **kw)


def convnextv2_femto(**kw):
    return ConvNeXtV2(depths=(2, 2, 6, 2), dims=(48, 96, 192, 384), **kw)


def convnextv2_pico(**kw):
    return ConvNeXtV2(depths=(2, 2, 6, 2), dims=(64, 128, 256, 512), **kw)


def convnextv2_nano(**kw):
    return ConvNeXtV2(depths=(2, 2, 8, 2), dims=(80, 160, 320, 640), **kw)


def convnextv2_tiny(**kw):
    return ConvNeXtV2(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), **kw)


def convnextv2_base(**kw):
    return ConvNeXtV2(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024), **kw)


def _resnet50(**kw):
    from .resnet import resnet50

    return resnet50(**kw)


def _resnet101(**kw):
    from .resnet import resnet101

    return resnet101(**kw)


MODELS = {
    "convnextv2_atto": convnextv2_atto,
    "convnextv2_femto": convnextv2_femto,
    "convnextv2_pico": convnextv2_pico,
    "convnextv2_nano": convnextv2_nano,
    "convnextv2_tiny": convnextv2_tiny,
    "convnextv2_base": convnextv2_base,
    "resnet50": _resnet50,
    "resnet101": _resnet101,
}
