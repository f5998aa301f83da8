"""Differentiable rigid-transform math on tensors.

Counterpart of gslam_tpu/core/transforms.py: the learnable camera pose is a
fixed base world-to-camera matrix composed with a small delta, a Zhou-6D
rotation plus a translation. All functions batch over leading dimensions
and are differentiable through autograd. Float32 matmuls stay in full
precision (TF32 is switched off in the package's __init__).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gslam_tpu_torch import resolve_device

# The 6D identity rotation (two orthonormal columns of I).
IDENTITY_6D = np.array([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], dtype=np.float32)


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al. continuous 6D rotation [..., 6] -> rotation [..., 3, 3].

    Gram-Schmidt on the two 3-vectors; rows of the result are the
    orthonormalized basis b1, b2, b3.
    """
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = _normalize(a1)
    b2 = _normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalizes wxyz quaternions [..., 4] -> rotations [..., 3, 3]."""
    q = _normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> wxyz unit quaternion with w >= 0.

    Branch-free: all four candidates (one per largest-diagonal case) are
    computed and the best-conditioned one is selected.
    """
    batch = m.shape[:-2]
    f = m.reshape(batch + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = [f[..., i] for i in range(9)]
    q_abs_sq = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    q_abs = torch.sqrt(torch.clamp(q_abs_sq, min=0.0))
    cand = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
        ],
        dim=-2,
    )  # [..., 4 candidates, 4]
    cand = cand / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(batch + (1, 4))
    q = torch.gather(cand, -2, idx)[..., 0, :]
    return torch.where(q[..., 0:1] < 0.0, -q, q)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis-angle vector -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], -1),
            torch.stack([wz, zeros, -wx], -1),
            torch.stack([-wy, wx, zeros], -1),
        ],
        dim=-2,
    )


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map: axis-angle [..., 3] -> rotation [..., 3, 3].

    Taylor expansions near zero keep gradients finite at the identity.
    """
    theta_sq = torch.sum(w * w, dim=-1)
    small = theta_sq < 1e-8
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / safe_sq)
    K = so3_hat(w)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> axis-angle [..., 3] (inverse of so3_exp)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    vee = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_sq = 0.25 * torch.sum(vee * vee, dim=-1)
    small = sin_sq < 1e-14
    sin_t = torch.clamp(
        torch.sqrt(torch.where(small, torch.ones_like(sin_sq), sin_sq)), 0.0, 1.0
    )
    theta = torch.atan2(sin_t, cos_t)
    scale = torch.where(small, torch.full_like(theta, 0.5), theta / (2.0 * sin_t))
    return scale[..., None] * vee


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation and [..., 3] translation -> [..., 4, 4]."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential: [..., 6] (rho, w) -> [..., 4, 4] homogeneous."""
    rho, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    theta_sq = torch.sum(w * w, dim=-1)
    small = theta_sq < 1e-8
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / safe_sq)
    c = torch.where(
        small, 1.0 / 6.0 - theta_sq / 120.0,
        (theta - torch.sin(theta)) / (safe_sq * theta),
    )
    K = so3_hat(w)
    V = _eye_like(K) + b[..., None, None] * K + c[..., None, None] * (K @ K)
    t = (V @ rho[..., None])[..., 0]
    return _homogeneous(R, t)


class PoseDelta(NamedTuple):
    """Learnable world-to-camera pose: base @ delta(d_rot6, d_t).

    `d_rot6` is added to the 6D identity, so zeros give the base pose.
    """

    base: torch.Tensor  # [..., 4, 4]
    d_rot6: torch.Tensor  # [..., 6]
    d_t: torch.Tensor  # [..., 3]


def identity_pose_delta(base: torch.Tensor | None = None,
                        device: str | torch.device | None = None) -> PoseDelta:
    """A zero delta on `base` ([..., 4, 4], made float32; the identity on
    `device`, CUDA by default, when None)."""
    if base is None:
        base = torch.eye(4, device=resolve_device(device))
    base = base.to(torch.float32)
    batch = base.shape[:-2]
    return PoseDelta(base=base,
                     d_rot6=torch.zeros(batch + (6,), device=base.device),
                     d_t=torch.zeros(batch + (3,), device=base.device))


def pose_matrix(p: PoseDelta) -> torch.Tensor:
    """Realize a PoseDelta into a 4x4 world-to-camera matrix (differentiable)."""
    ident = torch.as_tensor(IDENTITY_6D, device=p.d_rot6.device)
    rot = rotation_6d_to_matrix(p.d_rot6 + ident)
    return p.base @ _homogeneous(rot, p.d_t)


def rebase_pose(p: PoseDelta) -> PoseDelta:
    """Fold the current delta into the base, resetting the delta to zero."""
    return identity_pose_delta(pose_matrix(p))


def invert_se3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid [..., 4, 4] transform."""
    Rt = m[..., :3, :3].transpose(-1, -2)
    new_t = -(Rt @ m[..., :3, 3:4])[..., 0]
    return _homogeneous(Rt, new_t)
