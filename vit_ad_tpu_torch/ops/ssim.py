"""Structural similarity (port of `vit_ad_tpu/ops/ssim.py`).

torchmetrics' StructuralSimilarityIndexMeasure as the reference's recon
trainer uses it (reference src/classes/CnnAutoEncoder.py:48, data_range 1.0;
SSIM loss = 1 - SSIM, :77-83): an 11-tap gaussian of sigma 1.5, k1 0.01,
k2 0.03, VALID windows, biased variances, the mean over channels and pixels
per image. The five moment maps are blurred together by two separable
depthwise `conv2d` calls in f32; autograd differentiates through them (the SSIM
loss trains the decoder). No kernel: cuDNN's depthwise convolutions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """torchmetrics' gaussian over [-(size-1)/2 .. (size-1)/2] / sigma,
    normalised to sum 1, in f32."""
    coords = (np.arange(size, dtype=np.float64) - (size - 1) / 2.0) / sigma
    g = np.exp(-0.5 * coords ** 2)
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable VALID gaussian over H and W of an NCHW map, per channel."""
    c, k = x.shape[1], kernel.numel()
    x = F.conv2d(x, kernel.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, kernel.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def ssim_per_image(preds: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
                   kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
                   k2: float = 0.03) -> torch.Tensor:
    """Per-image SSIM [B] of two NCHW batches, computed in f32."""
    kernel = torch.from_numpy(gaussian_kernel_1d(kernel_size, sigma)).to(preds.device)
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    x, y = preds.float(), target.float()
    c = x.shape[1]
    moments = _blur(torch.cat([x, y, x * x, y * y, x * y], dim=1), kernel)
    mu_x, mu_y, mu_xx, mu_yy, mu_xy = moments.split(c, dim=1)
    sigma_x = mu_xx - mu_x * mu_x
    sigma_y = mu_yy - mu_y * mu_y
    sigma_xy = mu_xy - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return torch.mean(num / den, dim=(1, 2, 3))
