"""Continuous-time trajectory: cumulative cubic B-spline on SO(3) x R^3.

Counterpart of gslam_tpu/eval/spline.py. Control rotations are composed
through axis-angle Log/Exp with the cumulative-basis coefficients, so
interpolation, velocity and acceleration are differentiable functions of
the control points. `fit_spline` refines them with Adam, as an eager loop
through autograd (the JAX package folds the same steps into one lax.scan).

Basis (uniform cumulative cubic B-spline, u in [0,1)):
    c1 = (5 + 3u - 3u^2 + u^3)/6, c2 = (1 + 3u + 3u^2 - 2u^3)/6, c3 = u^3/6
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gslam_tpu_torch import resolve_device
from gslam_tpu_torch.core.transforms import quaternion_to_matrix, so3_exp, so3_log


class Spline(NamedTuple):
    rot_cps: torch.Tensor  # [M, 3, 3] control rotations (world-from-body)
    pos_cps: torch.Tensor  # [M, 3] control translations
    interval: float
    start_time: float
    n_active: torch.Tensor  # [] int32 number of valid control points


def init_spline(num_cps: int, interval: float, start_time: float,
                device: str | torch.device | None = None) -> Spline:
    """An identity spline on `device` (CUDA unless the caller names one)."""
    dev = resolve_device(device)
    return Spline(
        rot_cps=torch.eye(3, device=dev).repeat(num_cps, 1, 1),
        pos_cps=torch.zeros((num_cps, 3), device=dev),
        interval=float(interval),
        start_time=float(start_time),
        n_active=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _segment(sp: Spline, t: torch.Tensor):
    seg = torch.floor((t - sp.start_time) / sp.interval)
    seg = torch.clamp(seg, min=torch.ones_like(seg),
                      max=sp.n_active.to(torch.float32) - 2.0)
    u = (t - (seg * sp.interval + sp.start_time)) / sp.interval
    return seg.to(torch.int64), u


def _gather4(cps: torch.Tensor, seg: torch.Tensor):
    idx = seg[..., None] + torch.arange(-1, 3, device=seg.device)
    return cps[torch.clamp(idx, 0, cps.shape[0] - 1)]


def spline_pose(sp: Spline, times: torch.Tensor):
    """Interpolate world-from-body poses at `times` [T].
    Returns (R [T,3,3], p [T,3])."""
    seg, u = _segment(sp, times)
    u2, u3 = u * u, u * u * u
    c1 = (5.0 + 3 * u - 3 * u2 + u3) / 6.0
    c2 = (1.0 + 3 * u + 3 * u2 - 2 * u3) / 6.0
    c3 = u3 / 6.0

    R4 = _gather4(sp.rot_cps, seg)  # [T, 4, 3, 3]
    d = R4[:, :-1].transpose(-1, -2) @ R4[:, 1:]
    w = so3_log(d)  # [T, 3, 3vec]
    R = R4[:, 0]
    for k, c in enumerate((c1, c2, c3)):
        R = R @ so3_exp(w[:, k] * c[:, None])

    p4 = _gather4(sp.pos_cps, seg)  # [T, 4, 3]
    dp = p4[:, 1:] - p4[:, :-1]
    p = p4[:, 0] + c1[:, None] * dp[:, 0] + c2[:, None] * dp[:, 1] \
        + c3[:, None] * dp[:, 2]
    return R, p


def spline_velocity(sp: Spline, times: torch.Tensor) -> torch.Tensor:
    """Translational velocity [T, 3] (world frame)."""
    seg, u = _segment(sp, times)
    u2 = u * u
    c1 = (3.0 - 6 * u + 3 * u2) / 6.0
    c2 = (3.0 + 6 * u - 6 * u2) / 6.0
    c3 = (3 * u2) / 6.0
    p4 = _gather4(sp.pos_cps, seg)
    dp = p4[:, 1:] - p4[:, :-1]
    v = c1[:, None] * dp[:, 0] + c2[:, None] * dp[:, 1] + c3[:, None] * dp[:, 2]
    return v / sp.interval


def spline_acceleration(sp: Spline, times: torch.Tensor) -> torch.Tensor:
    """Translational acceleration [T, 3] (world frame)."""
    seg, u = _segment(sp, times)
    c1 = u - 1.0
    c2 = 1.0 - 2 * u
    c3 = u
    p4 = _gather4(sp.pos_cps, seg)
    dp = p4[:, 1:] - p4[:, :-1]
    a = c1[:, None] * dp[:, 0] + c2[:, None] * dp[:, 1] + c3[:, None] * dp[:, 2]
    return a / sp.interval**2


def seed_from_poses(sp: Spline, times: torch.Tensor, rot: torch.Tensor,
                    pos: torch.Tensor) -> Spline:
    """Seed control points by nearest-sample assignment of measured poses."""
    num_cps = sp.rot_cps.shape[0]
    cp_times = sp.start_time + torch.arange(num_cps, dtype=torch.float32,
                                            device=times.device) * sp.interval
    nearest = torch.argmin(torch.abs(cp_times[:, None] - times[None, :]), dim=1)
    n_active = torch.clamp(
        torch.floor((times.max() - sp.start_time) / sp.interval).to(torch.int32) + 1,
        max=num_cps)
    return sp._replace(rot_cps=rot[nearest], pos_cps=pos[nearest], n_active=n_active)


def fit_spline(
    sp: Spline,
    pose_times: torch.Tensor,  # [T]
    rot_meas: torch.Tensor,  # [T, 3, 3]
    pos_meas: torch.Tensor,  # [T, 3]
    accel_times: torch.Tensor | None = None,  # [A]
    accel_meas: torch.Tensor | None = None,  # [A, 3] world-frame acceleration
    n_steps: int = 200,
    lr: float = 1e-2,
    accel_weight: float = 1e-3,
) -> tuple[Spline, torch.Tensor]:
    """Refine control points against pose (and optionally accelerometer)
    residuals with `n_steps` Adam steps; rotations are optimized in the
    tangent space of the current control rotations. Returns the spline and
    the [n_steps] losses."""

    def with_params(dw, p):
        return sp._replace(rot_cps=sp.rot_cps @ so3_exp(dw), pos_cps=p)

    def loss_fn(dw, p):
        s = with_params(dw, p)
        R, pos = spline_pose(s, pose_times)
        rot_res = so3_log(R.transpose(-1, -2) @ rot_meas)
        loss = torch.mean(torch.sum((pos - pos_meas) ** 2, -1))
        loss = loss + torch.mean(torch.sum(rot_res**2, -1))
        if accel_times is not None:
            a = spline_acceleration(s, accel_times)
            loss = loss + accel_weight * torch.mean(torch.sum((a - accel_meas) ** 2, -1))
        return loss

    params = [torch.zeros_like(sp.pos_cps), sp.pos_cps.clone()]
    mu = [torch.zeros_like(x) for x in params]
    nu = [torch.zeros_like(x) for x in params]
    losses = []
    for i in range(n_steps):
        leaves = [x.detach().requires_grad_(True) for x in params]
        loss = loss_fn(*leaves)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(loss.detach())
        t = float(i + 1)
        with torch.no_grad():
            for k, g in enumerate(grads):
                mu[k] = 0.9 * mu[k] + 0.1 * g
                nu[k] = 0.999 * nu[k] + 0.001 * g * g
                params[k] = params[k] - lr * (mu[k] / (1 - 0.9**t)) / (
                    torch.sqrt(nu[k] / (1 - 0.999**t)) + 1e-8)
    with torch.no_grad():
        return with_params(*params), torch.stack(losses)


def rot_cps_from_quats(quats: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(quats)
