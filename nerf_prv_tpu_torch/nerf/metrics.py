"""Image quality metrics: PSNR + SSIM, in PyTorch.

Counterpart of ``nerf_prv_tpu/nerf/metrics.py``: metrics over
sRGB-clipped RGB against ground truth composited on a black background;
SSIM follows Wang et al. with the standard 11x11 Gaussian window, averaged
over channels.  Every function also takes a leading batch of frames.
"""

from __future__ import annotations

import torch


def linear_to_srgb(x):
    """≙ ngp's linear_to_srgb used at run.py:257-258."""
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, 12.92 * x, 1.055 * x ** (1.0 / 2.4) - 0.055)


def srgb_to_linear(x):
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def mse2psnr(mse):
    return -10.0 * torch.log10(torch.clamp_min(torch.as_tensor(mse), 1e-12))


def psnr(img, ref):
    """PSNR over the last three (H, W, C) axes."""
    return mse2psnr(torch.mean((img - ref) ** 2, dim=(-3, -2, -1)))


def _gaussian_kernel(size: int, sigma: float, device):
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


def ssim(img, ref, size: int = 11, sigma: float = 1.5, c1: float = 0.01**2, c2: float = 0.03**2):
    """Mean SSIM over (..., H, W, C) pairs in [0, 1]; one value per pair."""
    img = torch.as_tensor(img, dtype=torch.float32)
    ref = torch.as_tensor(ref, dtype=torch.float32)
    k = _gaussian_kernel(size, sigma, img.device)

    def blur(x):
        # separable Gaussian, valid padding, per channel, as shifted
        # multiply-adds in plain f32: a cuDNN convolution would run in
        # TF32 by default, and the variance cancellation
        # blur(x^2) - mu^2 then errs by far more than c2
        h = x.shape[-3] - size + 1
        x = sum(k[i] * x[..., i : i + h, :, :] for i in range(size))
        w = x.shape[-2] - size + 1
        return sum(k[i] * x[..., :, i : i + w, :] for i in range(size))

    mu_x = blur(img)
    mu_y = blur(ref)
    mu_x2 = mu_x * mu_x
    mu_y2 = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_x2 = blur(img * img) - mu_x2
    sigma_y2 = blur(ref * ref) - mu_y2
    sigma_xy = blur(img * ref) - mu_xy
    num = (2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sigma_x2 + sigma_y2 + c2)
    return torch.mean(num / den, dim=(-3, -2, -1))


def evaluate_pair(pred_rgb, gt_rgb):
    """(psnr, ssim, mse) for an image pair (or a batch), already sRGB [0,1]."""
    a = torch.clamp(pred_rgb, 0.0, 1.0)
    r = torch.clamp(gt_rgb, 0.0, 1.0)
    mse = torch.mean((a - r) ** 2, dim=(-3, -2, -1))
    return mse2psnr(mse), ssim(a, r), mse
