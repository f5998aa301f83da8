"""Reconstruction quality metrics (PSNR / SSIM).

Counterpart of gslam_tpu/eval/metrics.py: PSNR in float64 on the host,
SSIM with the kernel of the mapping loss (ops/ssim.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gslam_tpu_torch.ops.ssim import ssim as _ssim


def psnr(img: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(img, np.float64) - np.asarray(gt, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def eval_metrics(rendered: np.ndarray, gt: np.ndarray) -> dict:
    """PSNR + SSIM for one [H, W, 3] pair in [0, 1] (numpy, on the CPU)."""
    a = torch.as_tensor(np.asarray(rendered, np.float32))[None]
    b = torch.as_tensor(np.asarray(gt, np.float32))[None]
    return {"psnr": psnr(rendered, gt), "ssim": float(_ssim(a, b))}


def sanitize_metrics(obj):
    """NaN/Inf -> None, recursively, for strict-JSON metric dumps (`json.dumps`
    writes a bare NaN, which strict parsers reject)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: sanitize_metrics(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_metrics(v) for v in obj]
    return obj
