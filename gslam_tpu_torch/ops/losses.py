"""Loss terms for tracking and mapping.

Counterpart of gslam_tpu/ops/losses.py: the tracking photometric term, the
mapping photometric term with its log-beta prior, the isotropic scale
regularizer, the edge-aware depth total variation, the masked depth L1 and
the affine exposure.
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


def mapping_photometric(
    rendered: torch.Tensor,  # [C, H, W, 3] exposure-corrected
    gt: torch.Tensor,
    betas: torch.Tensor,  # [C, H, W]
    active_gs: bool = True,
    cam_mask: torch.Tensor | None = None,  # [C] bool: padded window slots
) -> torch.Tensor:
    err2 = torch.sum((rendered - gt) ** 2, dim=-1)  # [C, H, W]
    if cam_mask is not None:
        w = cam_mask.to(torch.float32)[:, None, None]
        denom = torch.clamp(torch.sum(w) * err2.shape[1] * err2.shape[2], min=1.0)
    else:
        w = torch.ones((1, 1, 1), dtype=torch.float32, device=err2.device)
        denom = err2.numel()
    if not active_gs:
        return torch.sum(err2 * w) / (3.0 * denom)  # plain mse over channels
    loss = torch.sum(err2 / (2.0 * betas**2) * w) / denom
    prior = torch.sum(torch.log(betas) ** 2 * 0.5 * w) / denom
    return loss + prior


def isotropic_scale_loss(
    log_scales: torch.Tensor,  # [cap, 3]
    visible: torch.Tensor,  # [cap] bool
) -> torch.Tensor:
    mean_scale = torch.exp(torch.mean(log_scales, dim=1, keepdim=True).detach())
    dev = torch.abs(torch.exp(log_scales) - mean_scale)
    return torch.sum(torch.where(visible[:, None], dev, 0.0))


def edge_aware_depth_tv(
    depth: torch.Tensor,  # [C, H, W]
    rgb: torch.Tensor,  # [C, H, W, 3]
    mask: torch.Tensor,  # [C, H, W] bool (alpha > 0.4 in the reference)
) -> torch.Tensor:
    gdx = torch.abs(depth[..., :, :-1] - depth[..., :, 1:])
    gdy = torch.abs(depth[..., :-1, :] - depth[..., 1:, :])
    gix = torch.mean(torch.abs(rgb[..., :, :-1, :] - rgb[..., :, 1:, :]), dim=-1)
    giy = torch.mean(torch.abs(rgb[..., :-1, :, :] - rgb[..., 1:, :, :]), dim=-1)
    gdx = gdx * torch.exp(-gix)
    gdy = gdy * torch.exp(-giy)
    return (torch.sum(torch.where(mask[..., :, :-1], gdx, 0.0))
            + torch.sum(torch.where(mask[..., :-1, :], gdy, 0.0)))


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
