"""Actor message protocol.

Counterpart of gslam_tpu/runtime/messages.py: the frontend sends
(ADD_FRAME, frame), (REQUEST_INIT, frame) or a None sentinel at the end of
the stream; the backend answers with a SYNC payload, a snapshot of the
map that the backend's later steps never change, with host metadata.
"""

from __future__ import annotations

import enum
from typing import NamedTuple


class FrontendMessage(enum.Enum):
    ADD_FRAME = "add_frame"
    ADD_REFINED_DEPTHMAP = "add_refined_depthmap"
    REQUEST_INIT = "request_init"


class BackendMessage(enum.Enum):
    SYNC = "sync"
    END_SYNC = "end_sync"


class SyncPayload(NamedTuple):
    gmap: object  # GaussianMap snapshot (its own copy of the backend's map)
    keyframe_poses: dict  # frame_idx -> np.ndarray [4,4]
    reference_depth: object  # [H, W] rendered depth of the latest keyframe
    reference_rgb: object  # [H, W, 3]
    pose_graph: dict  # frame_idx -> set(frame_idx)
    reference_alpha: object = None  # [H, W] rendered alpha of the latest kf
    reference_pose: object = None  # [4, 4] w2c of the latest keyframe
