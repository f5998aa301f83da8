"""Host-loop optimizers: L-BFGS and the tracker's Adam warm-up + L-BFGS."""

from gslam_tpu_torch.opt.lbfgs import LbfgsResult, lbfgs  # noqa: F401
