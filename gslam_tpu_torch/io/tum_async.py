"""Timestamp-merged asynchronous TUM stream (RGB + depth + IMU).

Counterpart of gslam_tpu/io/tum_async.py: instead of frame-synchronized
tuples, it yields every sensor event in timestamp order (accelerometer
packets at IMU rate interleaved with RGB and depth frames; on equal stamps
IMU, then RGB, then depth), which continuous-time (B-spline) trajectory
work consumes (eval/spline.py).
"""

from __future__ import annotations

import dataclasses
import heapq
from pathlib import Path

import numpy as np

from gslam_tpu_torch.io.frames import Frame
from gslam_tpu_torch.io.tum import TumRGBDataset


@dataclasses.dataclass
class IMUSample:
    accel: np.ndarray  # [3] m/s^2
    timestamp: float
    index: int


@dataclasses.dataclass
class DepthSample:
    depth: np.ndarray  # [H, W] meters
    timestamp: float
    index: int


class TumAsyncDataset:
    """Iterates (timestamp-ordered) IMUSample / Frame / DepthSample events."""

    def __init__(self, sequence_dir, seq_len: int = -1, with_depth: bool = True,
                 downscale: int = 1):
        self.rgbd = TumRGBDataset(sequence_dir, seq_len, downscale=downscale)
        self.dir = Path(sequence_dir)
        self.with_depth = with_depth
        try:
            acc = np.loadtxt(self.dir / "accelerometer.txt", comments="#")
            self.imu_stamps = acc[:, 0]
            self.imu_accel = acc[:, 1:4].astype(np.float32)
        except OSError:
            self.imu_stamps = np.zeros((0,))
            self.imu_accel = np.zeros((0, 3), np.float32)
        self.camera = self.rgbd.camera

    def init(self):
        return

    def __len__(self):
        return len(self.rgbd) + len(self.imu_stamps)

    def __iter__(self):
        def rgb_events():
            for i in range(len(self.rgbd)):
                frame = self.rgbd[i]
                yield (frame.timestamp, 1, frame)
                if self.with_depth and frame.gt_depth is not None:
                    depth_ts = float(self.rgbd.depth_stamps[
                        self.rgbd.nearest_depth[i]
                    ])
                    yield (depth_ts, 2, DepthSample(frame.gt_depth, depth_ts, i))

        def imu_events():
            for i, (ts, a) in enumerate(zip(self.imu_stamps, self.imu_accel)):
                yield (float(ts), 0, IMUSample(a, float(ts), i))

        for _, _, event in heapq.merge(
            rgb_events(), imu_events(), key=lambda e: (e[0], e[1])
        ):
            yield event

    def frames_only(self):
        for ev in self:
            if isinstance(ev, Frame):
                yield ev
