"""Trajectory and image metrics."""

from gslam_tpu_torch.eval.metrics import eval_metrics, psnr  # noqa: F401
from gslam_tpu_torch.eval.trajectory import (  # noqa: F401
    align_trajectory, ate_mean, ate_rmse, kabsch_umeyama,
)
