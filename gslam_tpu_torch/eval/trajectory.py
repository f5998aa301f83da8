"""Trajectory alignment and error metrics (host-side numpy).

Counterpart of gslam_tpu/eval/trajectory.py, kept as the port's own copy:
Sim(3) Kabsch-Umeyama alignment of the estimated trajectory onto ground
truth, the aligned translation error as a mean (the reference's "ATE") and
as an RMSE, and a top-down plot.
"""

from __future__ import annotations

import numpy as np


def kabsch_umeyama(a: np.ndarray, b: np.ndarray):
    """Similarity transform (R, c, t) minimizing ||a - (t + c R b)||.

    Args:
      a, b: [n, 3] point sets (a = target/gt frame).
    Returns:
      R [3,3], scale c (float), t [3].
    """
    assert a.shape == b.shape
    n, m = a.shape
    ea, eb = a.mean(axis=0), b.mean(axis=0)
    var_a = np.mean(np.linalg.norm(a - ea, axis=1) ** 2)
    cov = (a - ea).T @ (b - eb) / n
    try:
        u, d, vt = np.linalg.svd(cov)
        s = np.eye(m)
        if np.linalg.det(u) * np.linalg.det(vt) < 0:
            s[-1, -1] = -1.0
        rot = u @ s @ vt
        c = var_a / max(np.trace(np.diag(d) @ s), 1e-12)
        t = ea - c * rot @ eb
    except np.linalg.LinAlgError:
        rot, c, t = np.eye(m), 1.0, np.zeros(m)
    return rot, c, t


def align_trajectory(gt_t: np.ndarray, est_t: np.ndarray) -> np.ndarray:
    """Align estimated positions onto gt; returns aligned [n, 3]."""
    rot, c, t = kabsch_umeyama(gt_t, est_t)
    return (c * (rot @ est_t.T)).T + t


def ate_rmse(gt_t: np.ndarray, est_t: np.ndarray) -> float:
    """Root-mean-square aligned translation error (the standard ATE RMSE)."""
    aligned = align_trajectory(gt_t, est_t)
    return float(np.sqrt(np.mean(np.sum((aligned - gt_t) ** 2, axis=-1))))


def ate_mean(gt_t: np.ndarray, est_t: np.ndarray) -> float:
    """Mean aligned translation error, the statistic the reference reports
    as 'ATE' (per-frame errors averaged, not their RMS); metrics report both
    this and the RMSE."""
    aligned = align_trajectory(gt_t, est_t)
    return float(np.mean(np.linalg.norm(aligned - gt_t, axis=-1)))


def trajectory_positions(poses_w2c: np.ndarray) -> np.ndarray:
    """Camera centers from world-to-camera matrices: -R^T t. [n,4,4] -> [n,3]."""
    rot = poses_w2c[:, :3, :3]
    t = poses_w2c[:, :3, 3]
    return -np.einsum("nij,ni->nj", rot, t)


def plot_trajectories(gt_t, est_t, path, keyframe_indices=None):
    """Save a gt-vs-estimate top-down plot (matplotlib, Agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    aligned = align_trajectory(gt_t, est_t)
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(gt_t[:, 0], gt_t[:, 1], label="gt")
    ax.plot(aligned[:, 0], aligned[:, 1], label="estimate")
    if keyframe_indices is not None and len(keyframe_indices):
        ki = [i for i in keyframe_indices if i < len(aligned)]
        ax.scatter(aligned[ki, 0], aligned[ki, 1], marker="o", s=12)
    ax.set_aspect("equal")
    ax.legend()
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
