"""Map densification into the fixed-capacity buffer.

Counterpart of gslam_tpu/mapping/insertion.py:
  * `insert_from_depthmap` backprojects randomly picked pixels of a rendered
    (or mock) depth map into world space, with the depth noise, median
    fill, scale from the map's median (or from kNN on an empty map) and the
    multi-keyframe occlusion filter;
  * `densify_by_gradients` duplicates small and splits large splats whose
    image-plane gradient is high.
Candidates come at a static count, are compacted by a fixed-size nonzero
and written into dead slots; Adam moments at those slots are zeroed.

Random draws come in as tensors (`InsertDraws`, the densify noise), so a
caller decides where they come from: `insert_draws` makes them from a
`torch.Generator`, and parity tests pass the JAX package's own draws. The
JAX package picks pixels with `jax.random.categorical` over H*W logits;
`insert_draws` draws the same distribution (uniform over the pixels that
need geometry, over all pixels when none does) through the cumulative count
of those pixels, with no [n_new, H*W] tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from gslam_tpu_torch.core.camera import backproject
from gslam_tpu_torch.core.transforms import invert_se3
from gslam_tpu_torch.mapping.backend_ops import _set_rows
from gslam_tpu_torch.mapping.gaussians import (
    GaussianMap, compact_free_slots, masked_median, nonzero_fixed,
)
from gslam_tpu_torch.mapping.optimizer import MaskedAdamState, zero_state_at
from gslam_tpu_torch.ops.knn import mean_knn_scale
from gslam_tpu_torch.ops.projection import quat_scale_to_covar


@dataclasses.dataclass(frozen=True)
class InsertionConfig:
    depth_variance: float = 0.1  # noise std in valid-depth regions (x init scale)
    no_depth_variance: float = 0.2  # noise std where depth is unknown
    min_alpha_for_depth: float = 0.1
    initial_opacity: float = 0.3
    min_depth: float = 0.1
    logit_eps: float = 1.0 / 512.0


class InsertResult(NamedTuple):
    gmap: GaussianMap
    opt_state: MaskedAdamState
    n_inserted: torch.Tensor  # [] int32
    n_requested: torch.Tensor  # [] int32 candidates that passed the filters;
    # n_requested - n_inserted were dropped for lack of free slots


class InsertDraws(NamedTuple):
    noise: torch.Tensor  # [H*W] standard normal depth noise
    picks: torch.Tensor  # [n_new] int64 picked pixel (row-major)
    quats: torch.Tensor  # [n_new, 4] uniform [0, 1) initial rotations


def insertion_masks(depthmap: torch.Tensor, alphas: torch.Tensor, cfg: InsertionConfig,
                    gt_depthmap: torch.Tensor | None = None):
    """Flat [H*W] masks (trust, need): where the depth value is usable, and
    where the map has no geometry yet (candidates are picked there)."""
    depth_src = depthmap if gt_depthmap is None else gt_depthmap
    covered = (alphas > cfg.min_alpha_for_depth) & (depth_src > 0.0)
    trust = (depth_src > 0.0) if gt_depthmap is not None else covered
    return trust.reshape(-1), (~covered).reshape(-1)


def insert_draws(gen: torch.Generator, need: torch.Tensor, n_new: int) -> InsertDraws:
    """An insertion's draws from `gen` (a CPU generator: the card and the
    CPU get the same numbers), copied to the device of `need` [H*W]."""
    n_pix = need.shape[0]
    noise = torch.randn(n_pix, generator=gen)
    u = torch.rand(n_new, generator=gen, dtype=torch.float64)
    quats = torch.rand((n_new, 4), generator=gen)
    dev = need.device
    u = u.to(dev)
    # rank r of a uniform pick among the n_need pixels, then the pixel whose
    # inclusive count first exceeds r
    cum = torch.cumsum(need.to(torch.int64), 0)
    n_need = cum[-1]
    pool = torch.where(n_need > 0, n_need, n_pix)
    rank = torch.minimum((u * pool).to(torch.int64), pool - 1)
    in_need = torch.searchsorted(cum, rank, right=True)
    picks = torch.where(n_need > 0, in_need, rank)
    return InsertDraws(noise.to(dev), picks, quats.to(dev))


def _scatter_new_splats(
    gmap: GaussianMap,
    opt_state: MaskedAdamState,
    new: dict,  # candidate fields, leading dim n_new
    keep: torch.Tensor,  # [n_new] bool
    frame_index: int,
) -> InsertResult:
    n_new = keep.shape[0]
    cap = gmap.capacity
    order = nonzero_fixed(keep, n_new, n_new)
    slots = compact_free_slots(gmap.alive, n_new).to(torch.int64)
    ok = (order < n_new) & (slots < cap)
    src = torch.where(order < n_new, order, 0)

    def put(dst, vals):
        return _set_rows(dst, slots, ok, vals[src])

    gmap = GaussianMap(
        means=put(gmap.means, new["means"]),
        quats=put(gmap.quats, new["quats"]),
        log_scales=put(gmap.log_scales, new["log_scales"]),
        logit_opacities=put(gmap.logit_opacities, new["logit_opacities"]),
        logit_colors=put(gmap.logit_colors, new["logit_colors"]),
        log_uncertainties=put(gmap.log_uncertainties, new["log_uncertainties"]),
        ages=_set_rows(gmap.ages, slots, ok, torch.full_like(slots, frame_index)),
        alive=_set_rows(gmap.alive, slots, ok, torch.ones_like(ok)),
    )
    opt_state = zero_state_at(opt_state, torch.where(ok, slots, cap))
    return InsertResult(gmap, opt_state, n_inserted=torch.sum(ok.to(torch.int32)),
                        n_requested=torch.sum(keep.to(torch.int32)))


@torch.no_grad()
def insert_from_depthmap(
    draws: InsertDraws,
    gmap: GaussianMap,
    opt_state: MaskedAdamState,
    depthmap: torch.Tensor,  # [H, W] rendered (or mock) depth
    alphas: torch.Tensor,  # [H, W] rendered alpha
    image: torch.Tensor,  # [H, W, 3]
    K: torch.Tensor,  # [3, 3]
    viewmat: torch.Tensor,  # [4, 4] world-to-camera of the frame
    n_new: int,
    frame_index: int,
    cfg: InsertionConfig = InsertionConfig(),
    kf_viewmats: torch.Tensor | None = None,  # [Kf, 4, 4] for the occlusion filter
    kf_est_depths: torch.Tensor | None = None,  # [Kf, H, W]
    kf_mask: torch.Tensor | None = None,  # [Kf] bool
    gt_depthmap: torch.Tensor | None = None,  # optional RGB-D ground truth
) -> InsertResult:
    """Add up to `n_new` splats picked by `draws` (from `insert_draws` with
    this call's `need` mask, or the JAX package's). Reads one value back to
    the host: whether the map has a live splat (kNN scales on an empty map)."""
    H, W = depthmap.shape
    depth_src = depthmap if gt_depthmap is None else gt_depthmap
    flat_trust, flat_need = insertion_masks(depthmap, alphas, cfg, gt_depthmap)
    flat_depth = depth_src.reshape(-1)

    med = torch.where(flat_trust.any(), masked_median(flat_depth, flat_trust),
                      masked_median(flat_depth, torch.ones_like(flat_trust)))
    depths_mod = torch.where(flat_trust, flat_depth + draws.noise * cfg.depth_variance,
                             med + draws.noise * cfg.no_depth_variance)
    depths_mod = torch.clamp(depths_mod, min=cfg.min_depth)

    n_need = torch.sum(flat_need.to(torch.int32))
    keep = torch.arange(n_new, device=depthmap.device) < torch.clamp(n_need, max=n_new)

    picks = draws.picks
    cam_pts = backproject(K, depths_mod.reshape(H, W))[picks]  # [n_new, 3]
    c2w = invert_se3(viewmat)
    means_world = cam_pts @ c2w[:3, :3].T + c2w[:3, 3]
    colors = image.reshape(-1, 3)[picks]

    if bool(gmap.alive.any()):
        scales = masked_median(torch.exp(gmap.log_scales), gmap.alive)[None, :].expand(n_new, 3)
    else:
        scales = mean_knn_scale(means_world, 4)[:, None].expand(n_new, 3)

    eps = cfg.logit_eps
    f32 = dict(dtype=torch.float32, device=depthmap.device)
    new = dict(
        means=means_world,
        quats=draws.quats,
        log_scales=torch.log(torch.clamp(scales, min=1e-8)),
        logit_opacities=torch.full(
            (n_new,), math.log(cfg.initial_opacity / (1.0 - cfg.initial_opacity)), **f32),
        logit_colors=torch.logit(torch.clamp(colors, eps, 1.0 - eps)),
        log_uncertainties=torch.ones((n_new,), **f32),
    )

    if kf_viewmats is not None:
        # occlusion filter: drop candidates that land in front of a previous
        # keyframe's estimated depth
        p = torch.einsum("nj,kij->kni", means_world, kf_viewmats[:, :3, :3]) \
            + kf_viewmats[:, None, :3, 3]  # [Kf, n_new, 3]
        z = p[..., 2]
        z_div = torch.where(z > 0, z, 1.0)
        u = K[0, 0] * p[..., 0] / z_div + K[0, 2]
        v = K[1, 1] * p[..., 1] / z_div + K[1, 2]
        # clamping before the cast equals the JAX cast-then-clip on every
        # candidate the visibility test keeps, and never casts an
        # out-of-range float
        ui = torch.clamp(u, 0, W - 1).to(torch.int64)
        vi = torch.clamp(v, 0, H - 1).to(torch.int64)
        # 1px border margin: a candidate reprojected into the frame it came
        # from can land epsilon outside [0, W) in float32
        visible = (z > 0.01) & (u >= -1.0) & (u < W + 1.0) & (v >= -1.0) & (v < H + 1.0)
        kidx = torch.arange(kf_viewmats.shape[0], device=z.device)[:, None]
        front = z < kf_est_depths.reshape(-1)[(kidx * H + vi) * W + ui]
        keep = keep & ~torch.any(visible & front & kf_mask[:, None], dim=0)

    return _scatter_new_splats(gmap, opt_state, new, keep, frame_index)


@torch.no_grad()
def densify_by_gradients(
    noise: torch.Tensor,  # [max_new, 3] standard normal split offsets
    gmap: GaussianMap,
    opt_state: MaskedAdamState,
    means2d_grad: torch.Tensor,  # [C, cap, 2] dL/dmeans2d
    width: int,
    height: int,
    max_new: int,
    frame_index: int,
    grow_grad2d: float = 0.0002,
    grow_scale3d: float = 0.01,
) -> InsertResult:
    c = means2d_grad.shape[0]
    # the JAX scaling: c counts every window slot, padded ones included
    g = means2d_grad * torch.tensor([width / 2.0 * c, height / 2.0 * c],
                                    device=means2d_grad.device)
    gnorm = torch.mean(torch.linalg.norm(g, dim=-1), dim=0)  # [cap]

    high = (gnorm > grow_grad2d) & gmap.alive
    scales = torch.exp(gmap.log_scales)
    small = torch.amax(scales, dim=-1) <= grow_scale3d

    src = nonzero_fixed(high, max_new, gmap.capacity)
    keep = src < gmap.capacity
    src_safe = torch.where(keep, src, 0)

    is_split = ~small[src_safe]
    cov = quat_scale_to_covar(gmap.quats[src_safe], scales[src_safe])
    offset = torch.einsum("nij,nj->ni", cov, noise)
    means = gmap.means[src_safe] + torch.where(is_split[:, None], offset, 0.0)
    log_scales = gmap.log_scales[src_safe] - torch.where(
        is_split[:, None], torch.log(torch.tensor(1.6)).to(scales.device), 0.0)

    new = dict(
        means=means,
        quats=gmap.quats[src_safe],
        log_scales=log_scales,
        logit_opacities=gmap.logit_opacities[src_safe],
        logit_colors=gmap.logit_colors[src_safe],
        log_uncertainties=torch.ones((max_new,), dtype=torch.float32, device=noise.device),
    )
    return _scatter_new_splats(gmap, opt_state, new, keep, frame_index)
