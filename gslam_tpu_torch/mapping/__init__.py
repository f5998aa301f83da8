"""The splat map, its optimizer and the mapping backend's programs."""

from gslam_tpu_torch.mapping.gaussians import GaussianMap  # noqa: F401
from gslam_tpu_torch.mapping.optimizer import (  # noqa: F401
    MaskedAdamState, adam_step, init_adam,
)
