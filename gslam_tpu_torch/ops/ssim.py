"""SSIM with a separable 11-tap Gaussian window, 'valid' padding.

Counterpart of gslam_tpu/ops/ssim.py. The JAX package computes it with XLA
convolutions outside any Pallas kernel; here each pass of the separable
filter is one depthwise `F.conv2d` (groups = channels). TF32 stays off for
cuDNN (the package's __init__), so the filters run in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


_WINDOW = _gaussian_kernel()


def _filter2(img: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode Gaussian filter with taps `w` over [B, H, W, C]."""
    c = img.shape[-1]
    x = img.permute(0, 3, 1, 2)  # [B, C, H, W]
    x = F.conv2d(x, w.reshape(1, 1, -1, 1).repeat(c, 1, 1, 1), groups=c)
    x = F.conv2d(x, w.reshape(1, 1, 1, -1).repeat(c, 1, 1, 1), groups=c)
    return x.permute(0, 2, 3, 1)


def ssim_per_image(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image SSIM over [B, H, W, C] batches (valid padding). Returns [B]."""
    c1, c2 = 0.01**2, 0.03**2
    w = torch.as_tensor(_WINDOW, device=img1.device)  # one host-to-device copy
    mu1 = _filter2(img1, w)
    mu2 = _filter2(img2, w)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1 = _filter2(img1 * img1, w) - mu1_sq
    sigma2 = _filter2(img2 * img2, w) - mu2_sq
    sigma12 = _filter2(img1 * img2, w) - mu12
    num = (2 * mu12 + c1) * (2 * sigma12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (sigma1 + sigma2 + c2)
    return torch.mean(num / den, dim=(1, 2, 3))


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM over [B, H, W, C] image batches (valid padding)."""
    return torch.mean(ssim_per_image(img1, img2))
