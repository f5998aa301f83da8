"""Dense image-warp tracking (the alternative to splat-based tracking).

Counterpart of gslam_tpu/tracking/warp.py: backproject the reference
frame's depth, move it by the relative pose, reproject it into the new
view and bilinearly sample the new image there; the pose (and the affine
exposure) is optimized against the L1 photometric residual over the
in-bounds pixels. The bilinear gather is written out by hand (not
`grid_sample`), so the zero padding and the edge handling are the JAX
package's. Plain torch ops on the images' device; the optimizer is the
host-side L-BFGS of opt/lbfgs.py.
"""

from __future__ import annotations

import torch

from gslam_tpu_torch.core.transforms import PoseDelta, invert_se3, pose_matrix
from gslam_tpu_torch.opt.lbfgs import lbfgs_impl
from gslam_tpu_torch.tracking.track import TrackingConfig


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample img [H, W, C] at uv [N, 2] pixel coords; zero padding.

    Returns (samples [N, C], in_bounds [N])."""
    H, W = img.shape[:2]
    u, v = uv[:, 0], uv[:, 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = (u - u0)[:, None]
    dv = (v - v0)[:, None]
    u0i = u0.to(torch.int64)
    v0i = v0.to(torch.int64)

    def tap(vi, ui):
        ok = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        val = img[torch.clamp(vi, 0, H - 1), torch.clamp(ui, 0, W - 1)]
        return torch.where(ok[:, None], val, 0.0)

    s = (
        tap(v0i, u0i) * (1 - du) * (1 - dv)
        + tap(v0i, u0i + 1) * du * (1 - dv)
        + tap(v0i + 1, u0i) * (1 - du) * dv
        + tap(v0i + 1, u0i + 1) * du * dv
    )
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    return s, inb


def warp_image(
    ref_pose: torch.Tensor,  # [4, 4] w2c of the reference frame
    new_pose: torch.Tensor,  # [4, 4] w2c of the new frame
    ref_img: torch.Tensor,  # [H, W, 3]
    ref_depth: torch.Tensor,  # [H, W]
    K: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Where each reference pixel lands in the new view: (uv [H*W, 2],
    in front of the camera [H*W]). The caller samples the new image there
    and compares with the reference colors (the reference's residual)."""
    H, W = ref_depth.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    dev = ref_depth.device
    vs, us = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    d = ref_depth.reshape(-1)
    x = (us.reshape(-1) - cx) * d / fx
    y = (vs.reshape(-1) - cy) * d / fy
    pts_ref = torch.stack([x, y, d], -1)

    rel = new_pose @ invert_se3(ref_pose)
    pts_new = pts_ref @ rel[:3, :3].T + rel[:3, 3]
    z = torch.clamp(pts_new[:, 2], min=1e-6)
    u_new = fx * pts_new[:, 0] / z + cx
    v_new = fy * pts_new[:, 1] / z + cy
    return torch.stack([u_new, v_new], -1), pts_new[:, 2] > 1e-6


def warp_track(
    ref_pose: torch.Tensor,
    base_pose: torch.Tensor,  # initial guess for the new frame (w2c)
    ref_img: torch.Tensor,
    ref_depth: torch.Tensor,
    new_img: torch.Tensor,
    K: torch.Tensor,
    init_exposure: torch.Tensor,
    cfg: TrackingConfig = TrackingConfig(),
    ref_alpha: torch.Tensor | None = None,  # [H, W] rendered alpha of the ref
):
    """Optimize the new frame's pose by dense warp alignment. Returns
    (pose [4, 4], exposure [2], final loss []), on the images' device."""
    H, W = ref_depth.shape

    # rendered depth maps are alpha-premultiplied; warp geometry needs the
    # expected depth, and pixels the map barely covers carry none
    if ref_alpha is not None:
        depth_eff = ref_depth / torch.clamp(ref_alpha, min=1e-3)
        pix_ok = (ref_alpha > 0.5).reshape(-1)
    else:
        depth_eff = ref_depth
        pix_ok = (ref_depth > 1e-6).reshape(-1)
    new_flat = new_img.reshape(H, W, 3)
    ref_flat = ref_img.reshape(-1, 3)

    def loss_fn(x):
        pose = pose_matrix(PoseDelta(base_pose, x[:6], x[6:9]))
        uv, zok = warp_image(ref_pose, pose, ref_img, depth_eff, K)
        warped, inb = bilinear_sample(new_flat, uv)
        if cfg.learn_exposure:
            warped = warped * torch.exp(x[9]) + x[10]
        valid = (inb & zok & pix_ok)[:, None]
        resid = torch.where(valid, torch.abs(warped - ref_flat), 0.0)
        return torch.sum(resid) / torch.clamp(torch.sum(valid) * 3.0, min=1.0)

    x0 = torch.cat([torch.zeros(9, device=init_exposure.device), init_exposure.to(torch.float32)])
    # lr=1: the strong-Wolfe search owns the step size
    res = lbfgs_impl(loss_fn, x0, max_iter=cfg.lbfgs_max_iter, max_eval=cfg.lbfgs_max_eval,
                     history=cfg.lbfgs_history, lr=1.0)
    with torch.no_grad():
        pose = pose_matrix(PoseDelta(base_pose, res.x[:6], res.x[6:9]))
    return pose, res.x[9:11], res.f
