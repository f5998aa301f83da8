"""Plain video-file dataset (cv2.VideoCapture).

Counterpart of gslam_tpu/io/video.py: frames from a video with fixed
intrinsics and no ground truth, for monocular in-the-wild runs; skips the
first `start` frames (auto-exposure settling). cv2 is imported when a
dataset is built, not with the module.
"""

from __future__ import annotations

import numpy as np

import torch

from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.io.frames import Frame


class VideoDataset:
    def __init__(self, path, start: int = 30, downscale: int = 2,
                 fx: float | None = None, fy: float | None = None):
        import cv2

        self.cap = cv2.VideoCapture(str(path))
        if not self.cap.isOpened():
            raise FileNotFoundError(path)
        for _ in range(start):
            self.cap.read()
        w = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH)) // downscale
        h = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) // downscale
        self.downscale = downscale
        self.size = (w, h)
        fx = fx if fx is not None else 0.9 * w
        fy = fy if fy is not None else fx
        K = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]], np.float32)
        self.camera = Camera(K=torch.from_numpy(K), height=h, width=w)
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self._idx = 0

    def init(self):
        return

    def __iter__(self):
        import cv2

        while True:
            ok, frame_bgr = self.cap.read()
            if not ok:
                return
            frame = cv2.resize(frame_bgr, self.size, interpolation=cv2.INTER_AREA)
            rgb = np.float32(frame[..., ::-1]) / 255.0
            yield Frame(
                image=rgb,
                timestamp=self._idx / self.fps,
                camera=self.camera,
                index=self._idx,
            )
            self._idx += 1

    def __len__(self):
        return 10**9  # unknown; stream until exhausted
