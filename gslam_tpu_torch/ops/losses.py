"""Tracking loss terms.

Counterpart of gslam_tpu/ops/losses.py:18-31,83-115. The mapping losses
come with the mapping slice.
"""

from __future__ import annotations

import torch


def tracking_photometric(
    rendered: torch.Tensor,  # [..., 3] exposure-corrected render
    gt: torch.Tensor,  # [..., 3]
    betas: torch.Tensor,  # [...]
    kind: str = "active-nerf",
) -> torch.Tensor:
    err = rendered - gt
    if kind == "l1":
        return torch.mean(torch.abs(err))
    if kind == "mse":
        return torch.mean(err**2)
    if kind == "active-nerf":
        return torch.mean(torch.sum(err**2, dim=-1) * betas**-2.0)
    raise ValueError(kind)


def masked_depth_l1(
    rendered_depth: torch.Tensor,
    gt_depth: torch.Tensor,
    cam_mask: torch.Tensor | None = None,
    alpha: torch.Tensor | None = None,
    alpha_min: float = 0.0,
) -> torch.Tensor:
    """Mean |rendered - gt| depth over valid pixels: sensor depth present
    (gt > 0), optionally only where alpha > alpha_min. The alpha mask
    carries no gradient: it selects which pixels constrain the pose."""
    valid = gt_depth > 0.0
    if cam_mask is not None:
        valid = valid & cam_mask[:, None, None]
    if alpha is not None and alpha_min > 0.0:
        valid = valid & (alpha.detach() > alpha_min)
    err = torch.where(valid, torch.abs(rendered_depth - gt_depth), 0.0)
    return torch.sum(err) / torch.clamp(torch.sum(valid.to(torch.float32)), min=1.0)


def apply_exposure(rgb: torch.Tensor, exposure: torch.Tensor) -> torch.Tensor:
    """Affine exposure: rgb * exp(a) + b; exposure [..., 2] broadcasts over pixels."""
    a = exposure[..., 0]
    b = exposure[..., 1]
    shape = a.shape + (1,) * (rgb.dim() - a.dim())
    return rgb * torch.exp(a).reshape(shape) + b.reshape(shape)
