"""Fused tracking render: per-tile projection + the blend kernel, with no
per-evaluation gathers or scatters.

Counterpart of gslam_tpu/ops/track_fused.py. Tracking re-renders the same
frozen map up to ~200 times per frame while only the camera pose changes,
and the tile lists are frozen per frame. So the pose-independent splat data
is gathered ONCE per frame into splat-minor [T, c, M] rows, and each
evaluation projects per (tile, slot) elementwise and blends the rows. The
pose gradient is then a plain reduction over [T, M] in autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gslam_tpu_torch.mapping.gaussians import GaussianMap
from gslam_tpu_torch.ops.blend import blend_tiles_rows
from gslam_tpu_torch.ops.projection import (
    _camera_point, _clamped_tangent, _cov3d_components, _ewa_conic, _rotate_cov,
)
from gslam_tpu_torch.ops.rasterize import CameraBins, RenderConfig, untile


class TileGather(NamedTuple):
    """Per-frame, pose-independent gathered tile data (splat-minor rows)."""

    m3d: torch.Tensor  # [T, 3, M] world means
    cov6: torch.Tensor  # [T, 6, M] world covariance components
    opac: torch.Tensor  # [T, 1, M] sigmoid opacity, 0 at invalid slots
    color: torch.Tensor  # [T, 3, M] sigmoid colors
    beta: torch.Tensor  # [T, 1, M] clamped uncertainties


@torch.no_grad()
def gather_tracking_tiles(
    gmap: GaussianMap, bins: CameraBins, cam: int = 0
) -> TileGather:
    """Build row-layout per-tile tensors from the map + one camera's bins."""
    ids = bins.tile_gauss[cam].to(torch.int64)  # [T, M]
    mask = bins.tile_mask[cam]
    cov6 = torch.stack(_cov3d_components(gmap.quats, torch.exp(gmap.log_scales)))

    def rows(x_cn):  # [C_rows, N] -> [T, C_rows, M]
        return x_cn[:, ids].transpose(0, 1).contiguous()

    opac = torch.sigmoid(gmap.logit_opacities)
    opac = torch.where(gmap.alive, opac, 0.0)
    color = torch.sigmoid(gmap.logit_colors)
    beta = torch.clamp(torch.exp(gmap.log_uncertainties), min=0.01)
    return TileGather(
        m3d=rows(gmap.means.T),
        cov6=rows(cov6),
        opac=torch.where(mask, opac[ids], 0.0)[:, None, :],
        color=rows(color.T),
        beta=rows(beta[None, :]),
    )


def tracking_rows(
    tg: TileGather,
    viewmat: torch.Tensor,  # [4, 4] (differentiable)
    K: torch.Tensor,
    width: int,
    height: int,
    cfg: RenderConfig,
):
    """Per-(tile, slot) EWA projection at `viewmat`: the blend's row inputs
    xy [T,2,M], con [T,3,M], op [T,1,M] and feat [T,5,M] (rgb, depth, beta)."""
    R = viewmat[:3, :3]
    t = viewmat[:3, 3]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    px, py, z = _camera_point(R, t, tg.m3d[:, 0], tg.m3d[:, 1], tg.m3d[:, 2])
    in_depth = (z > cfg.near) & (z < cfg.far)
    z_safe = torch.where(in_depth, z, torch.ones_like(z))
    tx, ty = _clamped_tangent(px, py, z_safe, fx, fy, width, height)
    c_cam = _rotate_cov(R, tuple(tg.cov6[:, i] for i in range(6)))
    inv_z = 1.0 / z_safe
    a, b, cc, det = _ewa_conic(c_cam, tx, ty, inv_z, fx, fy, cfg.eps2d)
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))

    xy_rows = torch.stack([fx * px * inv_z + cx, fy * py * inv_z + cy], dim=1)
    con_rows = torch.stack([cc / det_safe, -b / det_safe, a / det_safe], dim=1)
    op_rows = torch.where(in_depth & det_ok, tg.opac[:, 0], 0.0)[:, None, :]
    feat_rows = torch.cat([tg.color, z[:, None, :], tg.beta], dim=1)
    return xy_rows, con_rows, op_rows, feat_rows


def render_tracking_fused(
    tg: TileGather,
    viewmat: torch.Tensor,  # [4, 4] (differentiable)
    K: torch.Tensor,
    width: int,
    height: int,
    cfg: RenderConfig,
):
    """Differentiable render of the pre-gathered tiles at `viewmat`.

    Returns (rgb [H,W,3], depth [H,W], beta [H,W], alpha [H,W]).
    """
    ts = cfg.tile_size
    tiles_x = -(-width // ts)
    tiles_y = -(-height // ts)
    out, t_final, _touched = blend_tiles_rows(
        *tracking_rows(tg, viewmat, K, width, height, cfg), ts, tiles_x,
        (cfg.alpha_cut, cfg.alpha_clamp, cfg.visibility_min_T),
    )
    # background: black rgb, zero depth, beta_background in the beta channel
    beta = out[..., 4] + t_final * cfg.beta_background

    def img(x):
        return untile(x[None], tiles_x, tiles_y, ts, width, height)[0]

    return img(out[..., :3]), img(out[..., 3]), img(beta), img(1.0 - t_final)
