"""Host-side frame record passed from a source to the SLAM runtime.

Counterpart of gslam_tpu/io/frames.py: frames are plain numpy until the
runtime uploads them; estimated state (pose, exposure) is filled in as the
frame flows through.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gslam_tpu_torch.core.camera import Camera


@dataclasses.dataclass
class Frame:
    image: np.ndarray  # [H, W, 3] float32 in [0, 1]
    timestamp: float
    camera: Camera
    index: int
    gt_pose: np.ndarray | None = None  # [4, 4] world-to-camera
    gt_depth: np.ndarray | None = None  # [H, W] float32 meters
    img_file: str | None = None
    # filled by the runtime:
    est_pose: np.ndarray | None = None  # [4, 4] world-to-camera
    exposure: np.ndarray | None = None  # [2]
    rejected: bool = False  # tracking guard fell back to the motion prior

    def strip(self) -> "Frame":
        """Drop image payloads, keep trajectory state."""
        return dataclasses.replace(self, image=None, gt_depth=None)
