"""Frame tracking against a frozen map."""

from gslam_tpu_torch.tracking.track import (  # noqa: F401
    TrackingConfig, constant_motion_prior, track_frame,
)
