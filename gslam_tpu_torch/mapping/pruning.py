"""Pruning strategies over the fixed-capacity buffer.

Counterpart of gslam_tpu/mapping/pruning.py: low opacity, oversized screen
footprint and ill-conditioned (visible but never contributing) splats, as
mask computations over the map and `mapping_step`'s `aux.radii` and
`aux.n_touched`; applying a prune clears live bits.
"""

from __future__ import annotations

import torch

from gslam_tpu_torch.mapping.gaussians import GaussianMap


def low_opacity_mask(gmap: GaussianMap, min_opacity: float = 0.2) -> torch.Tensor:
    return torch.sigmoid(gmap.logit_opacities) < min_opacity


def large_radius_mask(max_radii: torch.Tensor, max_radius: float = 256.0) -> torch.Tensor:
    """max_radii: [cap] max screen radius across rendered views."""
    return max_radii > max_radius


def ill_conditioned_mask(
    radii: torch.Tensor,  # [C, cap]
    n_touched: torch.Tensor,  # [C, cap]
    max_views: int = 3,
) -> torch.Tensor:
    useless = (radii > 0) & (n_touched == 0)
    return torch.sum(useless.to(torch.int32), dim=0) > max_views


def young_invisible_mask(
    gmap: GaussianMap,
    visibility_counts: torch.Tensor,  # [cap]
    latest_kf_age,
    min_visibility: int = 3,
    age_window: int = 3,
) -> torch.Tensor:
    young = gmap.ages > (latest_kf_age - age_window)
    return young & (visibility_counts < min_visibility)


def apply_prune(gmap: GaussianMap, remove_mask: torch.Tensor) -> GaussianMap:
    return gmap._replace(alive=gmap.alive & ~remove_mask)


def opacity_decay(
    gmap: GaussianMap, radii: torch.Tensor, decay: float = 0.995
) -> GaussianMap:
    """Decay the raw opacity logit of splats visible in more than one view
    (the reference multiplies the logit, not the opacity)."""
    seen = torch.sum((radii > 0).to(torch.int32), dim=0) > 1
    return gmap._replace(logit_opacities=torch.where(
        seen & gmap.alive, gmap.logit_opacities * decay, gmap.logit_opacities))
