"""Pinhole camera model.

Counterpart of gslam_tpu/core/camera.py: `Camera` is host-side metadata
(height and width are Python ints) beside the [3, 3] intrinsics tensor;
`backproject` lifts a depth map with pixel (u, v) at integer coordinates,
the reference's convention.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    K: torch.Tensor  # [3, 3] intrinsics
    height: int
    width: int

    def scaled(self, factor: float) -> "Camera":
        """Camera for an image scaled by `factor` (e.g. 0.5 for half-res)."""
        s = torch.tensor([[factor, 0, 0], [0, factor, 0], [0, 0, 1]],
                         dtype=torch.float32, device=self.K.device)
        return Camera(K=s @ self.K.to(torch.float32),
                      height=int(round(self.height * factor)),
                      width=int(round(self.width * factor)))


def pixel_grid(height: int, width: int, dtype=torch.float32,
               device: str | torch.device = "cpu") -> torch.Tensor:
    """[H, W, 2] grid of pixel (u, v) = (x, y) coordinates."""
    vs, us = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                            torch.arange(width, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([us, vs], dim=-1)


def backproject(K: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Lift a [H, W] depth map to [H*W, 3] camera-frame points."""
    H, W = depth.shape
    uv = pixel_grid(H, W, depth.dtype, depth.device)
    xs = (uv[..., 0] - K[0, 2]) * depth / K[0, 0]
    ys = (uv[..., 1] - K[1, 2]) * depth / K[1, 1]
    return torch.stack([xs, ys, depth], dim=-1).reshape(-1, 3)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a [4, 4] rigid transform to [N, 3] points."""
    return pts @ T[:3, :3].T + T[:3, 3]
