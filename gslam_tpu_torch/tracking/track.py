"""Per-frame camera tracking against a frozen Gaussian map.

Counterpart of gslam_tpu/tracking/track.py. The pose delta (Zhou-6D
rotation + translation) and the affine exposure pair are packed into one
11-vector (9 without exposure learning) and refined by one of two methods:

  * method="igs" (and "warp", which the JAX tracker also runs as igs: the
    frontend tracks by dense warp alignment only once a synced reference
    render exists): Adam warm-up steps, then L-BFGS with strong-Wolfe line
    search. Every loss evaluation renders the frame with the tile lists
    binned once at the prior pose: through the fused tracking render
    (per-tile projection + the blend kernels; fused=True, the default) or
    through the generic render_impl (fused=False). The objective is the
    uncertainty-weighted 'active-nerf' photometric loss with an optional
    alpha-masked expected-depth L1.
  * method="gn": Gauss-Newton / Levenberg-Marquardt on the weighted residual
    vector of the same objective. Each iteration linearizes the render once
    (torch.func.jvp under vmap: one primal pass and p tangents, through
    render_impl's forward-mode route, as the JAX tracker pins its jnp blend),
    solves the p x p damped normal system and renders once more to score the
    step.

Spans (runtime/trace.py): `track.frame` (track_frame), `track.level` (one
level of either method), `track.bins` (binning and gathering at the prior),
`track.optimizer` (warmup_lbfgs_impl, levenberg_marquardt), `track.eval`
(one evaluation: `track.render`, `track.loss`, and for igs `track.backward`
and `track.readback`), and for GN `track.linearize` (normal_equations),
`track.solve` and `track.readback`. The counter `track.evals` adds one an
evaluation: TrackResult.n_evals summed (GN: each linearization and each
scoring render).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from gslam_tpu_torch import resolve_device, to_device
from gslam_tpu_torch.core.transforms import PoseDelta, invert_se3, pose_matrix
from gslam_tpu_torch.mapping.gaussians import GaussianMap
from gslam_tpu_torch.ops.losses import (
    apply_exposure, masked_depth_l1, tracking_photometric,
)
from gslam_tpu_torch.ops.rasterize import RenderConfig, compute_bins, render_impl
from gslam_tpu_torch.ops.track_fused import (
    gather_tracking_tiles, render_tracking_fused,
)
from gslam_tpu_torch.opt.lbfgs_compact import warmup_lbfgs_impl
from gslam_tpu_torch.runtime import trace


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    method: str = "igs"  # 'igs' (L-BFGS) | 'gn' (Gauss-Newton) | 'warp' (frontend)
    photometric_loss: str = "active-nerf"  # 'l1' | 'mse' | 'active-nerf'
    pose_lr: float = 0.002
    warmup_steps: int = 10
    # up to 200 closure evaluations per frame, as the JAX tracker
    lbfgs_max_iter: int = 160
    lbfgs_max_eval: int = 200
    lbfgs_history: int = 5
    # divergence guard: a non-finite result or a per-frame translation
    # delta above this bound (map units) falls back to the motion prior
    max_step: float = 0.5
    # innovation-scaled plausibility gate, applied where a history gauge
    # exists (runtime/fused.py): a track is rejected when its translation
    # off the motion prior exceeds
    #   max(guard_innov_mult * innov_ema, guard_step_floor)
    #     + n_consecutive_rejections * max(2 innov_ema, guard_step_floor / 2)
    # or its rotation off the prior exceeds guard_max_rot radians; 0 disables
    guard_innov_mult: float = 3.5
    guard_step_floor: float = 0.03
    guard_max_rot: float = 0.35
    learn_exposure: bool = True
    use_gt_depths: bool = False
    depth_loss_weight: float = 1.0
    depth_alpha_min: float = 0.5
    bin_radius_margin: float = 1.5  # footprint inflation for bin reuse
    fused: bool = True  # per-tile fused projection + blend; False: render_impl
    # coarse-to-fine pyramid: level l runs the same refinement on a
    # 2^l-downsampled image, coarsest first; 1 = flat
    pyramid_levels: int = 1
    # per-level L-BFGS eval budgets, coarse -> fine
    pyramid_evals: tuple = (100, 70, 50)
    # Gauss-Newton (method='gn'): LM iterations per level, each one
    # linearization (primal + p tangent passes) and one candidate render
    gn_iters: int = 10
    gn_lambda0: float = 1e-2  # initial LM damping (scaled by diag(JtJ))
    gn_tol: float = 1e-5  # step-norm early exit
    gn_huber_depth: float = 0.02  # IRLS clamp for the depth L1 term (m)
    render: RenderConfig = RenderConfig()


class TrackResult(NamedTuple):
    pose: torch.Tensor  # [4, 4] refined world-to-camera
    exposure: torch.Tensor  # [2]
    loss: torch.Tensor  # [] final photometric loss
    n_evals: int  # loss/grad evaluations used
    rejected: bool  # guard fired; pose is the fallback prior


def constant_motion_prior(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """Constant-velocity pose prediction: b @ inv(a) @ b."""
    return (pose_b @ invert_se3(pose_a)) @ pose_b


def track_frame_impl(
    gmap: GaussianMap,
    base_pose: torch.Tensor,  # [4, 4] initial world-to-camera guess
    init_exposure: torch.Tensor,  # [2] seeded from the previous frame
    gt_img: torch.Tensor,  # [H, W, 3]
    K: torch.Tensor,  # [3, 3]
    width: int,
    height: int,
    cfg: TrackingConfig = TrackingConfig(),
    gt_depth: torch.Tensor | None = None,  # [H, W] for RGB-D mode
) -> TrackResult:
    """One level of refinement; all tensors lie on the map's device."""
    with trace.span("track.level"):
        # bin tiles ONCE at the prior pose with inflated footprints and
        # gather the pose-independent rows; each evaluation then only
        # projects per (tile, slot) and blends
        with trace.span("track.bins"):
            bins = compute_bins(
                gmap.means, gmap.quats, gmap.log_scales, gmap.alive,
                base_pose[None], K[None], width, height, cfg.render,
                radius_scale=cfg.bin_radius_margin,
            )
            if cfg.fused:
                tiles = gather_tracking_tiles(gmap, bins)
        dev = gmap.means.device

        def unpack(x):
            pose = pose_matrix(PoseDelta(base_pose, x[:6], x[6:9]))
            exposure = x[9:11] if cfg.learn_exposure else init_exposure
            return pose, exposure

        def loss_fn(x_host):
            with trace.span("track.render"):
                pose, exposure = unpack(x_host.to(dev))
                if cfg.fused:
                    rgb_img, depth_img, beta_img, alpha_img = render_tracking_fused(
                        tiles, pose, K, width, height, cfg.render)
                else:
                    out = render_impl(**gmap.render_kwargs(), viewmats=pose[None],
                                      Ks=K[None], width=width, height=height,
                                      cfg=cfg.render, bins=bins)
                    rgb_img, depth_img, beta_img, alpha_img = (
                        out.rgb[0], out.depth[0], out.beta[0], out.alpha[0])
            with trace.span("track.loss"):
                rgb = apply_exposure(rgb_img, exposure)
                loss = tracking_photometric(rgb, gt_img, beta_img, cfg.photometric_loss)
                if cfg.use_gt_depths and gt_depth is not None:
                    # alpha-normalized expected depth, differentiable through both
                    d_hat = depth_img / torch.clamp(alpha_img, min=1e-3)
                    loss = loss + cfg.depth_loss_weight * masked_depth_l1(
                        d_hat[None], gt_depth[None],
                        alpha=alpha_img[None], alpha_min=cfg.depth_alpha_min,
                    )
            return loss

        # the optimizer's 11-vector lives on the host; every evaluation's
        # render and gradient run on the map's device
        x0 = torch.cat([torch.zeros(9), init_exposure.detach().cpu().to(torch.float32)])
        x, f, n_evals = warmup_lbfgs_impl(
            loss_fn, x0,
            warmup_steps=cfg.warmup_steps,
            max_iter=cfg.lbfgs_max_iter,
            max_eval=cfg.lbfgs_max_eval,
            history=cfg.lbfgs_history,
            lr=cfg.pose_lr,
            warmup_lr=cfg.pose_lr,
        )
        # divergence guard: keep the motion prior when the refinement left
        # the photometric basin
        ok = (
            bool(torch.all(torch.isfinite(x)))
            and bool(torch.isfinite(f))
            and bool(torch.linalg.norm(x[6:9]) < cfg.max_step)
        )
        if not ok:
            x, f = x0, torch.tensor(1e3)  # finite sentinel far above real losses
        with torch.no_grad():
            pose, exposure = unpack(x.to(dev))
        return TrackResult(pose=pose, exposure=exposure, loss=f.to(dev),
                           n_evals=n_evals, rejected=not ok)


class GaussNewtonProblem:
    """The weighted residual vector of one tracking level and its normal
    system: the closures of the JAX package's track_frame_gn_impl.

    Residual rows, term for term the L-BFGS objective:
      * photometric: (exposure-corrected rgb - gt) / (beta sqrt(HW)) per
        channel, whose sum of squares is the 'active-nerf' tracking loss,
        with beta an IRLS weight held at the linearization point;
      * depth (RGB-D): the alpha-normalized expected-depth residual with
        IRLS weights w^2 = depth_loss_weight / (max(|r|, gn_huber_depth) *
        n_valid), so the quadratic model reproduces the alpha-masked depth
        L1 around the linearization point.
    Tiles are binned once, at the prior pose, outside the linearized render.
    """

    def __init__(self, gmap: GaussianMap, base_pose, init_exposure, gt_img, K,
                 width: int, height: int, cfg: TrackingConfig, gt_depth=None):
        self.gmap, self.base_pose, self.init_exposure = gmap, base_pose, init_exposure
        self.gt_img, self.K, self.width, self.height, self.cfg = gt_img, K, width, height, cfg
        self.p = 11 if cfg.learn_exposure else 9
        self.use_depth = cfg.use_gt_depths and gt_depth is not None
        self.gt_depth = gt_depth.reshape(-1) if self.use_depth else None
        with trace.span("track.bins"):
            self.bins = compute_bins(
                gmap.means, gmap.quats, gmap.log_scales, gmap.alive,
                base_pose[None], K[None], width, height, cfg.render,
                radius_scale=cfg.bin_radius_margin,
            )

    def x0(self) -> torch.Tensor:
        """The starting vector, p long (the JAX tracker's is 11 long even
        when p = 9, which its linearization cannot take: C-ref1)."""
        zeros = torch.zeros(9, device=self.gmap.means.device)
        if not self.cfg.learn_exposure:
            return zeros
        return torch.cat([zeros, self.init_exposure.to(torch.float32)])

    def unpack(self, x):
        pose = pose_matrix(PoseDelta(self.base_pose, x[:6], x[6:9]))
        exposure = x[9:11] if self.cfg.learn_exposure else self.init_exposure
        return pose, exposure

    def residuals(self, x):
        """Raw residuals [HW*3] and [HW] (or [1] without depth) and the
        primal beta and alpha [HW] that the IRLS weights come from."""
        pose, exposure = self.unpack(x)
        out = render_impl(**self.gmap.render_kwargs(), viewmats=pose[None],
                          Ks=self.K[None], width=self.width, height=self.height,
                          cfg=self.cfg.render, bins=self.bins, forward_mode=True)
        err = (apply_exposure(out.rgb[0], exposure) - self.gt_img).reshape(-1)
        if self.use_depth:
            d_hat = out.depth[0] / torch.clamp(out.alpha[0], min=1e-3)
            derr = d_hat.reshape(-1) - self.gt_depth
        else:
            derr = torch.zeros(1, device=x.device)
        return err, derr, out.beta[0].reshape(-1), out.alpha[0].reshape(-1)

    def _valid(self, alpha):
        valid = (self.gt_depth > 0.0) & (alpha > self.cfg.depth_alpha_min)
        return valid, torch.clamp(torch.sum(valid.to(torch.float32)), min=1.0)

    def weights(self, derr, beta, alpha):
        """IRLS row weights at the linearization point."""
        w_rgb = 1.0 / (beta * math.sqrt(self.height * self.width))
        if not self.use_depth:
            return w_rgb, torch.zeros_like(derr)
        valid, nv = self._valid(alpha)
        w2 = self.cfg.depth_loss_weight / (
            torch.clamp(torch.abs(derr), min=self.cfg.gn_huber_depth) * nv)
        return w_rgb, torch.where(valid, torch.sqrt(w2), 0.0)

    def loss(self, err, derr, beta, alpha):
        """The L-BFGS objective at a rendered point."""
        loss = torch.mean(torch.sum(err.reshape(-1, 3) ** 2, dim=-1) * beta ** -2.0)
        if self.use_depth:
            valid, nv = self._valid(alpha)
            loss = loss + self.cfg.depth_loss_weight * (
                torch.sum(torch.where(valid, torch.abs(derr), 0.0)) / nv)
        return loss

    def normal_equations(self, x):
        """JtJ [p, p] and Jtr [p] of the weighted residual at x: one
        linearization, the primal render once and p tangent passes."""
        with trace.span("track.linearize"):
            trace.count("track.evals")

            def linearize(t):
                return torch.func.jvp(self.residuals, (x,), (t,))

            eye = torch.eye(self.p, device=x.device)
            (err, derr, beta, alpha), (Je, Jd, _, _) = torch.func.vmap(
                linearize, out_dims=(None, 0))(eye)
            w_rgb, w_d = self.weights(derr, beta, alpha)
            w3 = torch.repeat_interleave(w_rgb, 3)  # channel-interleaved, as err
            r = torch.cat([err * w3, derr * w_d])
            J = torch.cat([Je * w3, Jd * w_d], dim=1)  # [p, HW*3 + HW]
            return J @ J.T, J @ r


def levenberg_marquardt(prob: GaussNewtonProblem, cfg: TrackingConfig):
    """Up to cfg.gn_iters LM iterations from prob.x0(): solve
    (JtJ + lambda diag(JtJ) + 1e-8 I) delta = -Jtr in float32, render the
    candidate, accept it if its loss is finite and lower (lambda * 0.33) or
    keep x (lambda * 10). Stops after an accepted step shorter than gn_tol
    or once lambda > 1e7. Everything stays on x's device but one read of
    (accepted, done, loss) per iteration.

    Returns (x, f, n_evals, steps): n_evals counts render passes (1 + 2 per
    iteration); steps holds each iteration's (accepted, loss after it)."""
    def score(x):
        with trace.span("track.eval"):
            trace.count("track.evals")
            with trace.span("track.render"):
                rendered = prob.residuals(x)
            with trace.span("track.loss"):
                return prob.loss(*rendered)

    with trace.span("track.optimizer"):
        x = prob.x0()
        f = score(x)
        lam = torch.tensor(cfg.gn_lambda0, device=x.device)
        eye = torch.eye(prob.p, device=x.device)
        n_evals, steps = 1, []
        for _ in range(cfg.gn_iters):
            JtJ, Jtr = prob.normal_equations(x)
            with trace.span("track.solve"):
                A = JtJ + lam * torch.diag(torch.diagonal(JtJ)) + 1e-8 * eye
                delta = -torch.linalg.solve_ex(A, Jtr).result
                x_new = x + delta
            f_new = score(x_new)
            better = torch.isfinite(f_new) & (f_new < f)
            x = torch.where(better, x_new, x)
            f = torch.where(better, f_new, f)
            lam = torch.where(better, lam * 0.33, lam * 10.0)
            done = (better & (torch.linalg.norm(delta) < cfg.gn_tol)) | (lam > 1e7)
            n_evals += 2
            with trace.span("track.readback"):
                better, done, loss = torch.stack([better, done, f]).tolist()
            steps.append((bool(better), loss))
            if done:
                break
        return x, f, n_evals, steps


def track_frame_gn_impl(
    gmap: GaussianMap,
    base_pose: torch.Tensor,
    init_exposure: torch.Tensor,
    gt_img: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    cfg: TrackingConfig = TrackingConfig(),
    gt_depth: torch.Tensor | None = None,
) -> TrackResult:
    """One level of Levenberg-Marquardt refinement (method="gn"); all
    tensors lie on the map's device. `n_evals` counts render passes; the
    divergence guard is the igs tracker's."""
    with trace.span("track.level"):
        prob = GaussNewtonProblem(gmap, base_pose, init_exposure, gt_img, K, width,
                                  height, cfg, gt_depth)
        x, f, n_evals, _ = levenberg_marquardt(prob, cfg)
        ok = bool(torch.all(torch.isfinite(x)) & torch.isfinite(f)
                  & (torch.linalg.norm(x[6:9]) < cfg.max_step))
        if not ok:
            x, f = prob.x0(), torch.tensor(1e3, device=x.device)
        with torch.no_grad():
            pose, exposure = prob.unpack(x)
        return TrackResult(pose=pose, exposure=exposure, loss=f, n_evals=n_evals,
                           rejected=not ok)


def _halve_image(img: torch.Tensor) -> torch.Tensor:
    """2x2 average pool over the leading [H, W, ...] axes."""
    H, W = img.shape[0], img.shape[1]
    rest = tuple(img.shape[2:])
    return img.reshape((H // 2, 2, W // 2, 2) + rest).mean(dim=(1, 3))


def _halve_K(K: torch.Tensor) -> torch.Tensor:
    """Intrinsics of the 2x-downsampled image: fx' = fx/2, cx' = (cx-0.5)/2
    (coarse pixel u' averages full-res pixels 2u' and 2u'+1)."""
    s = torch.tensor([[0.5, 0, 0], [0, 0.5, 0], [0, 0, 1.0]], dtype=K.dtype,
                     device=K.device)
    off = torch.tensor([[0, 0, -0.25], [0, 0, -0.25], [0, 0, 0]], dtype=K.dtype,
                       device=K.device)
    return s @ K + off


def track_frame_pyramid_impl(
    gmap: GaussianMap,
    base_pose: torch.Tensor,
    init_exposure: torch.Tensor,
    gt_img: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    cfg: TrackingConfig = TrackingConfig(),
    gt_depth: torch.Tensor | None = None,
) -> TrackResult:
    """Coarse-to-fine refinement: each level is a full `track_frame_impl` at
    a 2^l-downsampled resolution, seeded with the level above's pose and
    exposure, by `track_frame_gn_impl` when cfg.method == "gn". `n_evals`
    sums over levels; `rejected` is True only when every level's guard
    fired."""
    impl = track_frame_gn_impl if cfg.method == "gn" else track_frame_impl
    L = cfg.pyramid_levels
    # only as many levels as the image size halves into
    while L > 1 and (width % (1 << (L - 1)) or height % (1 << (L - 1))):
        L -= 1
    if L <= 1:
        return impl(gmap, base_pose, init_exposure, gt_img, K, width, height, cfg,
                    gt_depth)

    imgs, depths, Ks = [gt_img], [gt_depth], [K]
    for _ in range(L - 1):
        imgs.append(_halve_image(imgs[-1]))
        depths.append(None if depths[-1] is None else _halve_image(depths[-1]))
        Ks.append(_halve_K(Ks[-1]))

    pose, exposure = base_pose, init_exposure
    n_evals, all_rejected, loss = 0, True, None
    for lvl in range(L - 1, -1, -1):  # coarsest first
        s = 1 << lvl
        evals = int(cfg.pyramid_evals[L - 1 - lvl])
        rcfg = cfg.render
        if lvl > 0:
            # a coarse image has 4^l fewer tiles over the same splats: grow
            # the tile budget to match, capped at 512 as in the reference
            # (its cap is a TPU memory limit; the CUDA kernels take larger M,
            # but the cap is kept so both packages blend the same lists), and
            # shrink the forward-mode route's chunk to keep its temporaries
            cap = min(rcfg.tile_capacity * 4**lvl, 512)
            rcfg = dataclasses.replace(
                rcfg, tile_capacity=cap,
                tile_chunk=max(1, (rcfg.tile_capacity * rcfg.tile_chunk) // cap))
        cfg_l = dataclasses.replace(
            cfg,
            lbfgs_max_eval=evals,
            lbfgs_max_iter=min(cfg.lbfgs_max_iter, evals),
            # warm-up matters at the coarsest level (farthest prior)
            warmup_steps=(cfg.warmup_steps if lvl == L - 1
                          else min(cfg.warmup_steps, 3)),
            pyramid_levels=1,
            render=rcfg,
        )
        r = impl(gmap, pose, exposure, imgs[lvl], Ks[lvl], width // s, height // s,
                 cfg_l, depths[lvl])
        pose, exposure = r.pose, r.exposure
        n_evals += r.n_evals
        all_rejected = all_rejected and r.rejected
        loss = r.loss
    return TrackResult(pose=pose, exposure=exposure, loss=loss,
                       n_evals=n_evals, rejected=all_rejected)


def track_frame(
    gmap: GaussianMap,
    base_pose,
    init_exposure,
    gt_img,
    K,
    width: int,
    height: int,
    cfg: TrackingConfig = TrackingConfig(),
    gt_depth=None,
    device: str | torch.device | None = None,
) -> TrackResult:
    """Public entry point: track one frame on `device` (CUDA by default).

    Array arguments may be tensors or numpy arrays; they are moved to the
    device. The map must already lie on it.
    """
    dev = resolve_device(device)
    if gmap.means.device.type != dev.type:
        raise ValueError(f"the map lies on {gmap.means.device}, tracking on {dev}")

    with trace.span("track.frame"):
        return track_frame_pyramid_impl(
            gmap, *(to_device(x, dev) for x in (base_pose, init_exposure, gt_img, K)),
            width, height, cfg, to_device(gt_depth, dev))
