"""Render configuration and per-camera tile binning.

Counterpart of gslam_tpu/ops/rasterize.py:45-73,252-312. The generic
multi-camera render (`render_impl`, `_blend_tiles`) is not ported yet
(ROADMAP A11); tracking renders through ops/track_fused.py.

The compositing has no early termination: the reference declares a
`transmittance_cut` it never reads, so the port has no such field and
every splat of a tile's list is blended.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from gslam_tpu_torch.ops.binning import bin_gaussians
from gslam_tpu_torch.ops.projection import project_gaussians


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    tile_size: int = 16
    tile_capacity: int = 256  # max splats blended per tile (nearest kept)
    pairs_per_gaussian: int = 8  # pair budget = N * this
    max_span: int = 16  # max tile-footprint side per splat
    near: float = 0.01
    far: float = 1e10
    eps2d: float = 0.3
    radius_clip: float = 0.0
    visibility_min_T: float = 0.5
    beta_background: float = math.e
    alpha_clamp: float = 0.999
    alpha_cut: float = 1.0 / 255.0


class CameraBins(NamedTuple):
    """Per-camera tile lists, reused across re-renders while the pose moves
    only a few pixels (the tracking line search)."""

    tile_gauss: torch.Tensor  # [C, T, M] int32
    tile_mask: torch.Tensor  # [C, T, M] bool
    n_pairs: torch.Tensor  # [C] int32


@torch.no_grad()
def compute_bins(
    means: torch.Tensor,
    quats: torch.Tensor,
    log_scales: torch.Tensor,
    alive: torch.Tensor,
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    cfg: RenderConfig = RenderConfig(),
    radius_scale: float = 1.0,
) -> CameraBins:
    """Tile binning only (no gradients). `radius_scale` > 1 inflates splat
    footprints so the lists stay valid as the pose shifts during a tracking
    refinement."""
    n = means.shape[0]
    ts = cfg.tile_size
    tiles_x = -(-width // ts)
    tiles_y = -(-height // ts)
    scales = torch.exp(log_scales)
    out = []
    for vm, K in zip(viewmats, Ks):
        proj = project_gaussians(
            means, quats, scales, vm, K, width, height,
            near=cfg.near, far=cfg.far, eps2d=cfg.eps2d,
            radius_clip=cfg.radius_clip, alive=alive,
        )
        out.append(bin_gaussians(
            proj.means2d, proj.radii * radius_scale, proj.depths, proj.valid,
            ts, tiles_x, tiles_y, int(cfg.pairs_per_gaussian * n),
            cfg.tile_capacity, cfg.max_span,
        ))
    return CameraBins(
        tile_gauss=torch.stack([b.tile_gauss for b in out]),
        tile_mask=torch.stack([b.tile_mask for b in out]),
        n_pairs=torch.stack([b.n_pairs for b in out]),
    )
