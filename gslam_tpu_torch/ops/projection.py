"""EWA perspective projection of 3D Gaussians (plain torch, differentiable).

Counterpart of gslam_tpu/ops/projection.py. Elementwise math over the splat
axis; autograd carries gradients to means, quats, scales and the viewmat
(tracking optimizes on the viewmat gradient).

Conventions: viewmat is world-to-camera [4, 4]; quats are wxyz and need not
be normalized; the 2D covariance gets +eps2d on its diagonal; radius =
ceil(3 sigma_max) of the blurred 2D covariance; a splat is valid iff
radius > radius_clip, depth in (near, far), det > 0 and its 3-sigma box
touches the image.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gslam_tpu_torch.core.transforms import quaternion_to_matrix


class ProjectionOutput(NamedTuple):
    means2d: torch.Tensor  # [N, 2] pixel coords
    depths: torch.Tensor  # [N] camera-space z
    conics: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    radii: torch.Tensor  # [N] float, 0 for culled splats
    valid: torch.Tensor  # [N] bool


def _cov3d_components(quats: torch.Tensor, scales: torch.Tensor):
    """Upper-triangular world covariance R diag(s^2) R^T as six [N] tensors."""
    q = quats / torch.clamp(
        torch.sqrt(torch.sum(quats * quats, dim=-1, keepdim=True)), min=1e-12
    )
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy_, xz_, yz_ = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    s0, s1, s2 = scales[..., 0], scales[..., 1], scales[..., 2]
    m00 = (1.0 - 2.0 * (yy + zz)) * s0
    m01 = (2.0 * (xy_ - wz)) * s1
    m02 = (2.0 * (xz_ + wy)) * s2
    m10 = (2.0 * (xy_ + wz)) * s0
    m11 = (1.0 - 2.0 * (xx + zz)) * s1
    m12 = (2.0 * (yz_ - wx)) * s2
    m20 = (2.0 * (xz_ - wy)) * s0
    m21 = (2.0 * (yz_ + wx)) * s1
    m22 = (1.0 - 2.0 * (xx + yy)) * s2
    c00 = m00 * m00 + m01 * m01 + m02 * m02
    c01 = m00 * m10 + m01 * m11 + m02 * m12
    c02 = m00 * m20 + m01 * m21 + m02 * m22
    c11 = m10 * m10 + m11 * m11 + m12 * m12
    c12 = m10 * m20 + m11 * m21 + m12 * m22
    c22 = m20 * m20 + m21 * m21 + m22 * m22
    return c00, c01, c02, c11, c12, c22


def quat_scale_to_covar(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Covariance R diag(s^2) R^T for activated scales, [N, 4], [N, 3] ->
    [N, 3, 3] (the split densification samples offsets with it)."""
    M = quaternion_to_matrix(quats) * scales[..., None, :]
    return M @ M.transpose(-1, -2)


def _rotate_cov(R: torch.Tensor, c):
    """Sigma_cam = R Sigma_world R^T, expanded elementwise.

    R is one camera's [3, 3]; c are six world-covariance component tensors
    of any common shape. Returns the six camera-frame components.
    """
    c00, c01, c02, c11, c12, c22 = c

    def row_sigma(r):  # (R Sigma) row given R row r = (a, b, d)
        a, b, d = r[0], r[1], r[2]
        return (
            a * c00 + b * c01 + d * c02,
            a * c01 + b * c11 + d * c12,
            a * c02 + b * c12 + d * c22,
        )

    s0, s1, s2 = row_sigma(R[0]), row_sigma(R[1]), row_sigma(R[2])

    def dot_row(s, r):
        return s[0] * r[0] + s[1] * r[1] + s[2] * r[2]

    return (
        dot_row(s0, R[0]), dot_row(s0, R[1]), dot_row(s0, R[2]),
        dot_row(s1, R[1]), dot_row(s1, R[2]), dot_row(s2, R[2]),
    )


def _ewa_conic(c, tx, ty, inv_z, fx, fy, eps2d):
    """2D covariance J Sigma J^T (+eps2d) from camera-frame components c.

    Returns (a, b, cc, det); J rows are [fx/z, 0, -fx tx/z^2] and
    [0, fy/z, -fy ty/z^2].
    """
    c00, c01, c02, c11, c12, c22 = c
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22) + eps2d
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    cc = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22) + eps2d
    return a, b, cc, a * cc - b * b


def _camera_point(R, t, mx, my, mz):
    px = R[0, 0] * mx + R[0, 1] * my + R[0, 2] * mz + t[0]
    py = R[1, 0] * mx + R[1, 1] * my + R[1, 2] * mz + t[1]
    z = R[2, 0] * mx + R[2, 1] * my + R[2, 2] * mz + t[2]
    return px, py, z


def _clamped_tangent(px, py, z_safe, fx, fy, width, height):
    """gsplat's frustum clamp of x/z, y/z (keeps near-FOV Jacobians finite)."""
    lim_x = 1.3 * 0.5 * width / fx
    lim_y = 1.3 * 0.5 * height / fy
    tx = z_safe * torch.clamp(px / z_safe, -lim_x, lim_x)
    ty = z_safe * torch.clamp(py / z_safe, -lim_y, lim_y)
    return tx, ty


def project_gaussians(
    means: torch.Tensor,  # [N, 3] world-space centers
    quats: torch.Tensor,  # [N, 4] wxyz
    scales: torch.Tensor,  # [N, 3] activated (exp'd) scales
    viewmat: torch.Tensor,  # [4, 4] world-to-camera
    K: torch.Tensor,  # [3, 3]
    width: int,
    height: int,
    near: float = 0.01,
    far: float = 1e10,
    eps2d: float = 0.3,
    radius_clip: float = 0.0,
    alive: torch.Tensor | None = None,  # [N] bool; dead splats culled
) -> ProjectionOutput:
    R = viewmat[:3, :3]
    t = viewmat[:3, 3]
    px, py, z = _camera_point(R, t, means[..., 0], means[..., 1], means[..., 2])
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    in_depth = (z > near) & (z < far)
    z_safe = torch.where(in_depth, z, torch.ones_like(z))
    tx, ty = _clamped_tangent(px, py, z_safe, fx, fy, width, height)

    c_cam = _rotate_cov(R, _cov3d_components(quats, scales))
    inv_z = 1.0 / z_safe
    a, b, c, det = _ewa_conic(c_cam, tx, ty, inv_z, fx, fy, eps2d)
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    # 3-sigma radius from the larger eigenvalue of the blurred covariance
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    v_max = torch.maximum(mid + disc, mid - disc)
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(v_max, min=0.0))).detach()

    mean2d = torch.stack([fx * px * inv_z + cx, fy * py * inv_z + cy], dim=-1)
    inside = (
        (mean2d[..., 0] + radius > 0)
        & (mean2d[..., 0] - radius < width)
        & (mean2d[..., 1] + radius > 0)
        & (mean2d[..., 1] - radius < height)
    )
    valid = in_depth & det_ok & inside & (radius > radius_clip)
    if alive is not None:
        valid = valid & alive
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return ProjectionOutput(
        means2d=mean2d, depths=z, conics=conic, radii=radius, valid=valid
    )
