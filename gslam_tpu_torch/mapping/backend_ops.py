"""Compute programs of the mapping backend.

Counterpart of gslam_tpu/mapping/backend_ops.py:
  * `mapping_step`: one windowed map-optimization iteration. It renders the
    keyframe window through the generic render (one launch of each blend
    kernel per window camera), takes the four-term loss (photometric + SSIM
    + isotropic + edge-aware depth TV, or depth L1 with ground-truth
    depths), then one masked-Adam step on the splat buffer, one Adam step
    on the window poses (keyframe 0 frozen) and the per-iteration opacity
    decay. It also returns dL/dmeans2d through a zero probe added to the
    projected means.
  * `pose_refinement_lbfgs`: L-BFGS on the window's pose deltas alone,
    against the photometric loss of the window's render (one launch of each
    blend kernel per window camera and evaluation), the first keyframe and
    padded slots pinned;
  * the render-only programs: `keyframe_decision_stats`,
    `render_view_stats`, `eval_views` and `visibility_pass`.

The window has `window_size` slots and a mask: padded slots read keyframe
slot 0 and their writes are dropped. Every program runs on the device of
the map it is given.

Spans of a mapping step (runtime/trace.py): `map.step`, holding
`map.render` (projection, binning, gather and blend), `map.loss` (the loss
terms and SSIM), `map.backward` (autograd.grad) and `map.adam` (the masked
Adam step, the pose Adam and the opacity decay).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch

from gslam_tpu_torch import resolve_device
from gslam_tpu_torch.core.transforms import PoseDelta, invert_se3, pose_matrix
from gslam_tpu_torch.mapping.gaussians import GaussianMap, masked_median
from gslam_tpu_torch.mapping.keyframes import KeyframeStore
from gslam_tpu_torch.mapping.optimizer import MaskedAdamState, adam_step
from gslam_tpu_torch.mapping.pruning import opacity_decay
from gslam_tpu_torch.ops.losses import (
    apply_exposure, edge_aware_depth_tv, isotropic_scale_loss,
    mapping_photometric, masked_depth_l1,
)
from gslam_tpu_torch.ops.rasterize import RenderConfig, RenderOutput, render_impl
from gslam_tpu_torch.ops.ssim import ssim_per_image
from gslam_tpu_torch.opt.lbfgs import lbfgs_impl
from gslam_tpu_torch.runtime import trace


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Mapping hyperparameters, every field of the JAX package's MapConfig
    with its default (which mirror the reference's). The mapping step, its
    render programs and the pruning masks read the loss, window and prune
    fields; the fused runtime (runtime/fused.py) reads the keyframe policy,
    initialisation, plateau, densification and pose-graph fields."""

    isotropic_weight: float = 0.0005
    depth_tv_weight: float = 0.000001
    ssim_weight: float = 0.2
    pose_lr: float = 0.003
    opacity_decay: float = 0.995
    initial_opacity: float = 0.3
    initial_scale: float = 1.0
    window_size: int = 10  # 8 recent (+2 random; see window policy)
    recent_window: int = 8
    num_iters_mapping: int = 15
    num_iters_init: int = 400
    opacity_prune_threshold: float = 0.2
    size_prune_threshold: float = 256.0
    active_gs: bool = True
    min_visibility_views: int = 3
    enable_visibility_pruning: bool = False
    enable_pgo: bool = False
    kf_cov: float = 0.9
    kf_oc: float = 0.99
    kf_m: float = 0.15
    kf_cos: float = math.cos(math.pi / 30)
    # motion-adaptive keyframe trigger: also take a keyframe once the camera
    # has moved kf_adapt times its own EMA per-frame step since the last
    # keyframe (0 disables)
    kf_adapt: float = 2.5
    use_gt_depths: bool = False
    depth_loss_weight: float = 0.1
    plateau_patience: int = 3
    # 0.0 = plateau pause disabled (mapping never stops early)
    plateau_min_loss: float = 0.0
    densify_every: int = 200
    densify_max_new: int = 4096
    grow_grad2d: float = 0.0002
    grow_scale3d: float = 0.01
    background: tuple = (0.0, 0.0, 0.0)
    render: RenderConfig = RenderConfig()


class PoseAdamState(NamedTuple):
    mu: torch.Tensor  # [K, 9]
    nu: torch.Tensor  # [K, 9]
    count: torch.Tensor  # [K] int32 per-keyframe step (a keyframe added
    # mid-run starts at step 0)


def init_pose_adam(capacity: int, device: str | torch.device | None = None
                   ) -> PoseAdamState:
    dev = resolve_device(device)
    return PoseAdamState(
        torch.zeros((capacity, 9), device=dev), torch.zeros((capacity, 9), device=dev),
        torch.zeros((capacity,), dtype=torch.int32, device=dev),
    )


class MappingAux(NamedTuple):
    total_loss: torch.Tensor
    photometric_loss: torch.Tensor
    radii: torch.Tensor  # [W, cap]
    n_touched: torch.Tensor  # [W, cap]
    depthmaps: torch.Tensor  # [W, H, W]
    means2d_grad: torch.Tensor  # [W, cap, 2]
    n_pairs: torch.Tensor  # [W]


@functools.lru_cache(maxsize=None)
def _background_on(background: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(background, dtype=torch.float32, device=device)


def _background(cfg: MapConfig, device: torch.device) -> torch.Tensor:
    """cfg.background as a [3] tensor on `device`, copied there once per
    value and device (the render programs never change it)."""
    return _background_on(tuple(cfg.background), device)


def _window_loss(
    gmap_trainable: dict,
    gmap: GaussianMap,
    pose_vec: torch.Tensor,  # [W, 9]
    probe: torch.Tensor,  # [W, cap, 2]
    pose_base: torch.Tensor,  # [W, 4, 4]
    gt_imgs: torch.Tensor,
    gt_depths: torch.Tensor,
    exposures: torch.Tensor,
    cam_mask: torch.Tensor,
    Ks: torch.Tensor,
    width: int,
    height: int,
    cfg: MapConfig,
) -> tuple[torch.Tensor, tuple[torch.Tensor, RenderOutput]]:
    with trace.span("map.render"):
        g = gmap.with_trainable(gmap_trainable)
        viewmats = pose_matrix(PoseDelta(pose_base, pose_vec[:, :6], pose_vec[:, 6:9]))
        out = render_impl(
            **g.render_kwargs(), viewmats=viewmats, Ks=Ks, width=width, height=height,
            bg_rgb=_background(cfg, pose_vec.device), cfg=cfg.render, probe2d=probe,
        )
    with trace.span("map.loss"):
        rendered = apply_exposure(out.rgb, exposures)
        photo = mapping_photometric(rendered, gt_imgs, out.beta, active_gs=cfg.active_gs,
                                    cam_mask=cam_mask)

        radii_m = torch.where(cam_mask[:, None], out.radii, 0.0)
        visible = torch.sum((radii_m > 0).to(torch.int32), dim=0) > 0
        iso = isotropic_scale_loss(g.log_scales, visible & g.alive)

        ssim_vals = ssim_per_image(out.rgb, gt_imgs)
        w = cam_mask.to(torch.float32)
        ssim_loss = 1.0 - torch.sum(ssim_vals * w) / torch.clamp(torch.sum(w), min=1.0)

        total = ((1.0 - cfg.ssim_weight) * photo + cfg.ssim_weight * ssim_loss
                 + cfg.isotropic_weight * iso)
        if not cfg.use_gt_depths:
            tv = edge_aware_depth_tv(out.depth, out.rgb,
                                     (out.alpha > 0.4) & cam_mask[:, None, None])
            total = total + cfg.depth_tv_weight * tv
        else:
            total = total + cfg.depth_loss_weight * masked_depth_l1(out.depth, gt_depths,
                                                                    cam_mask)
    return total, (photo, out)


class WindowGrads(NamedTuple):
    total_loss: torch.Tensor
    photometric_loss: torch.Tensor
    out: RenderOutput
    g_map: dict  # field -> dL/dfield, [cap, ...]
    g_pose: torch.Tensor  # [W, 9]
    g_probe: torch.Tensor  # [W, cap, 2] = dL/dmeans2d
    pose_vec: torch.Tensor  # [W, 9] the window's pose deltas


def window_grads(gmap: GaussianMap, kf: KeyframeStore, window_idx: torch.Tensor,
                 window_mask: torch.Tensor, K: torch.Tensor, width: int, height: int,
                 cfg: MapConfig = MapConfig()) -> WindowGrads:
    """The window loss and its gradients to the map fields, the window's
    pose deltas and the means2d probe, in one autograd.grad call."""
    Wn = window_idx.shape[0]
    safe_idx = torch.where(window_mask, window_idx, 0).to(torch.int64)
    pose_vec = torch.cat([kf.d_rot6[safe_idx], kf.d_t[safe_idx]], dim=-1)
    params = {f: v.detach().requires_grad_(True) for f, v in gmap.trainable().items()}
    pose_vec.requires_grad_(True)
    probe = torch.zeros((Wn, gmap.capacity, 2), device=gmap.means.device,
                        requires_grad=True)
    total, (photo, out) = _window_loss(
        params, gmap, pose_vec, probe, kf.pose_base[safe_idx], kf.images[safe_idx],
        kf.gt_depths[safe_idx], kf.exposures[safe_idx], window_mask,
        K[None].expand(Wn, 3, 3), width, height, cfg)
    inputs = [*params.values(), pose_vec, probe]
    with trace.span("map.backward"):
        grads = torch.autograd.grad(total, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
    return WindowGrads(
        total_loss=total.detach(), photometric_loss=photo.detach(),
        out=RenderOutput(*(x.detach() for x in out)),
        g_map=dict(zip(params, grads[:-2])), g_pose=grads[-2], g_probe=grads[-1],
        pose_vec=pose_vec.detach())


def _set_rows(x: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """A copy of x with rows idx[i] set to values[i] where mask[i]; the
    other writes are dropped (the JAX scatter's mode="drop"). They go to a
    spare row, so a padded slot that reads slot 0 never races a real write
    to slot 0."""
    out = torch.cat([x, x[:1]])
    out[torch.where(mask, idx.to(torch.int64), x.shape[0])] = values.to(x.dtype)
    return out[:-1]


@torch.no_grad()
def _pose_adam(pose_opt: PoseAdamState, pose_vec, g_pose, safe_idx, upd_mask, lr):
    """Adam on the window's pose deltas, with each keyframe's own step
    count; rows outside upd_mask keep their values."""
    g_pose = torch.where(upd_mask[:, None], g_pose, 0.0)
    count = pose_opt.count[safe_idx] + upd_mask.to(torch.int32)
    t = torch.clamp(count.to(torch.float32), min=1.0)[:, None]
    mu = 0.9 * pose_opt.mu[safe_idx] + 0.1 * g_pose
    nu = 0.999 * pose_opt.nu[safe_idx] + 0.001 * g_pose * g_pose
    step = lr * (mu / (1 - 0.9**t)) / (torch.sqrt(nu / (1 - 0.999**t)) + 1e-8)
    new_vec = torch.where(upd_mask[:, None], pose_vec - step, pose_vec)
    return new_vec, mu, nu, count


def mapping_step(
    gmap: GaussianMap,
    opt_state: MaskedAdamState,
    kf: KeyframeStore,
    pose_opt: PoseAdamState,
    window_idx: torch.Tensor,  # [W] int slots into the keyframe store
    window_mask: torch.Tensor,  # [W] bool
    K: torch.Tensor,  # [3, 3] shared intrinsics
    width: int,
    height: int,
    cfg: MapConfig = MapConfig(),
):
    """One mapping iteration on the map's device. Returns (gmap, opt_state,
    kf, pose_opt, aux) as new tensors; the inputs are left as they were."""
    with trace.span("map.step"):
        wg = window_grads(gmap, kf, window_idx, window_mask, K, width, height, cfg)
        with torch.no_grad(), trace.span("map.adam"):
            gmap, opt_state = adam_step(gmap, wg.g_map, opt_state)

            # pose Adam on the window; the very first keyframe stays fixed
            safe_idx = torch.where(window_mask, window_idx, 0).to(torch.int64)
            upd_mask = window_mask & (kf.frame_idx[safe_idx] != 0)
            new_vec, mu, nu, count = _pose_adam(pose_opt, wg.pose_vec, wg.g_pose,
                                                safe_idx, upd_mask, cfg.pose_lr)
            kf = kf._replace(
                d_rot6=_set_rows(kf.d_rot6, window_idx, window_mask, new_vec[:, :6]),
                d_t=_set_rows(kf.d_t, window_idx, window_mask, new_vec[:, 6:9]),
                est_depths=_set_rows(kf.est_depths, window_idx, window_mask, wg.out.depth),
            )
            pose_opt = PoseAdamState(*(_set_rows(x, window_idx, upd_mask, v)
                                       for x, v in zip(pose_opt, (mu, nu, count))))

            # per-iteration opacity decay of splats seen by more than one window
            # view; padded cameras re-render slot 0's pose, so they are masked out
            radii_m = torch.where(window_mask[:, None], wg.out.radii, 0.0)
            n_touched_m = torch.where(window_mask[:, None], wg.out.n_touched, 0)
            gmap = opacity_decay(gmap, radii_m, cfg.opacity_decay)

        aux = MappingAux(
            total_loss=wg.total_loss, photometric_loss=wg.photometric_loss,
            radii=radii_m, n_touched=n_touched_m, depthmaps=wg.out.depth,
            means2d_grad=wg.g_probe, n_pairs=wg.out.n_pairs,
        )
        return gmap, opt_state, kf, pose_opt, aux


def pose_refinement_lbfgs(
    gmap: GaussianMap,
    kf: KeyframeStore,
    window_idx: torch.Tensor,
    window_mask: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    cfg: MapConfig = MapConfig(),
):
    """L-BFGS refinement of the window's poses on the photometric loss alone.
    Returns (kf, f, n_evals): the store with the masked slots' deltas
    written back, the final loss and the evaluations the search took."""
    Wn = window_idx.shape[0]
    safe_idx = torch.where(window_mask, window_idx, 0).to(torch.int64)
    gt_imgs = kf.images[safe_idx]
    pose_base = kf.pose_base[safe_idx]
    exposures = kf.exposures[safe_idx]
    Ks = K[None].expand(Wn, 3, 3)
    x0 = torch.cat([kf.d_rot6[safe_idx], kf.d_t[safe_idx]], dim=-1).reshape(-1)

    frozen = ~window_mask | (kf.frame_idx[safe_idx] == 0)
    free = torch.repeat_interleave(~frozen, 9).to(torch.float32)
    bg = _background(cfg, x0.device)

    def loss_fn(x):
        x_eff = x0 + (x - x0) * free  # frozen coords pinned to initial values
        vec = x_eff.reshape(Wn, 9)
        viewmats = pose_matrix(PoseDelta(pose_base, vec[:, :6], vec[:, 6:9]))
        out = render_impl(**gmap.render_kwargs(), viewmats=viewmats, Ks=Ks, width=width,
                          height=height, bg_rgb=bg, cfg=cfg.render)
        rendered = apply_exposure(out.rgb, exposures)
        return mapping_photometric(rendered, gt_imgs, out.beta, active_gs=cfg.active_gs,
                                   cam_mask=window_mask)

    res = lbfgs_impl(loss_fn, x0, max_iter=20, max_eval=25, history=10, lr=1.0,
                     tol_change=1e-7)
    with torch.no_grad():
        vec = (x0 + (res.x - x0) * free).reshape(Wn, 9)
        kf = kf._replace(d_rot6=_set_rows(kf.d_rot6, window_idx, window_mask, vec[:, :6]),
                         d_t=_set_rows(kf.d_t, window_idx, window_mask, vec[:, 6:9]))
    return kf, res.f, res.n_evals


def _render_views(gmap: GaussianMap, poses, K, width, height, cfg: MapConfig
                  ) -> RenderOutput:
    return render_impl(
        **gmap.render_kwargs(), viewmats=poses,
        Ks=K[None].expand(poses.shape[0], 3, 3), width=width, height=height,
        bg_rgb=_background(cfg, gmap.means.device), cfg=cfg.render)


class KeyframeStats(NamedTuple):
    translation: torch.Tensor
    median_depth: torch.Tensor
    cos_z: torch.Tensor
    iou: torch.Tensor
    new_visible: torch.Tensor  # [cap]
    prev_visible: torch.Tensor  # [cap]
    new_depth: torch.Tensor  # [H, W] rendered depth at the new frame
    new_alpha: torch.Tensor  # [H, W]


@torch.no_grad()
def keyframe_decision_stats(
    gmap: GaussianMap,
    new_pose: torch.Tensor,  # [4, 4]
    prev_pose: torch.Tensor,  # [4, 4]
    K: torch.Tensor,
    width: int,
    height: int,
    cfg: MapConfig = MapConfig(),
) -> KeyframeStats:
    """The renders and statistics behind the keyframe-insertion test and
    the covisibility edges."""
    out = _render_views(gmap, torch.stack([new_pose, prev_pose]), K, width, height, cfg)
    new_vis = out.radii[0] > 0
    prev_vis = out.radii[1] > 0
    inter = torch.sum((new_vis & prev_vis).to(torch.float32))
    union = torch.clamp(torch.sum((new_vis | prev_vis).to(torch.float32)), min=1.0)

    rel = invert_se3(new_pose) @ prev_pose
    translation = torch.linalg.norm(rel[:3, 3])
    valid = (out.alpha > 0.1).reshape(-1)
    med = masked_median(out.depth.reshape(-1), valid)

    z_new = new_pose[:3, 2]
    z_prev = prev_pose[:3, 2]
    cos_z = torch.dot(z_new, z_prev) / torch.clamp(
        torch.linalg.norm(z_new) * torch.linalg.norm(z_prev), min=1e-12)
    return KeyframeStats(
        translation=translation, median_depth=med, cos_z=cos_z, iou=inter / union,
        new_visible=new_vis, prev_visible=prev_vis, new_depth=out.depth[0],
        new_alpha=out.alpha[0],
    )


class ViewStats(NamedTuple):
    radii: torch.Tensor  # [cap]
    n_touched: torch.Tensor  # [cap]
    depth: torch.Tensor  # [H, W]
    alpha: torch.Tensor  # [H, W]
    rgb: torch.Tensor  # [H, W, 3]


@torch.no_grad()
def render_view_stats(gmap: GaussianMap, pose: torch.Tensor, K: torch.Tensor,
                      width: int, height: int, cfg: MapConfig = MapConfig()
                      ) -> ViewStats:
    """Single-view render + per-splat stats (pruning pass / sync payload)."""
    out = _render_views(gmap, pose[None], K, width, height, cfg)
    return ViewStats(radii=out.radii[0], n_touched=out.n_touched[0],
                     depth=out.depth[0], alpha=out.alpha[0], rgb=out.rgb[0])


@torch.no_grad()
def eval_views(gmap: GaussianMap, poses: torch.Tensor, gt_imgs: torch.Tensor,
               K: torch.Tensor, width: int, height: int, cfg: MapConfig = MapConfig()
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-view PSNR and SSIM of B renders of the map ([B] each)."""
    out = _render_views(gmap, poses, K, width, height, cfg)
    rendered = torch.clamp(out.rgb, 0.0, 1.0)
    mse = torch.mean((rendered - gt_imgs) ** 2, dim=(1, 2, 3))
    psnr = 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))
    return psnr, ssim_per_image(rendered, gt_imgs)


@torch.no_grad()
def visibility_pass(gmap: GaussianMap, poses: torch.Tensor, K: torch.Tensor,
                    width: int, height: int, cfg: MapConfig = MapConfig()
                    ) -> torch.Tensor:
    """[B, cap] visibility (radii > 0) for covisibility/pose-graph checks."""
    return _render_views(gmap, poses, K, width, height, cfg).radii > 0
