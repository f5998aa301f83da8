"""Pose math and the pinhole camera."""

from gslam_tpu_torch.core.camera import Camera, backproject, pixel_grid  # noqa: F401
from gslam_tpu_torch.core.transforms import (  # noqa: F401
    PoseDelta, identity_pose_delta, matrix_to_quaternion, pose_matrix, quaternion_to_matrix,
    rotation_6d_to_matrix, se3_exp, so3_exp, so3_log,
)
