"""Brute-force k-nearest-neighbor distances.

Counterpart of gslam_tpu/ops/knn.py: a dense [n, n] distance matrix in the
expanded form |a|^2 + |b|^2 - 2ab (float32 matmul, TF32 off), clamped at
zero, and the k smallest entries per row. The fused runtime calls it once,
on the bootstrap insertion's candidates (5,000 points: a 100 MB matrix).
"""

from __future__ import annotations

import torch


def knn_distances(points: torch.Tensor, k: int) -> torch.Tensor:
    """[n, k] Euclidean distances to the k nearest neighbors, ascending
    (column 0 is the zero self-distance)."""
    sq = torch.sum(points * points, dim=-1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (points @ points.T), min=0.0)
    return torch.sqrt(torch.topk(d2, k, dim=-1, largest=False).values)


def mean_knn_scale(points: torch.Tensor, k: int = 4) -> torch.Tensor:
    """Mean distance to the k-1 nearest neighbors, per point ([n])."""
    return torch.mean(knn_distances(points, k)[:, 1:], dim=-1)
