"""Replica sequence loader (traj.txt + results/frame*, depth* layout).

Counterpart of gslam_tpu/io/replica.py: thumbnails frames to fit 600x340,
scales depth by 1/5000 and nearest-resizes it to the thumbnail, fixed
intrinsics. PIL is imported when a frame is read, not with the module.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

import torch

from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.io.frames import Frame


class ReplicaDataset:
    def __init__(self, sequence_dir, seq_len: int = -1, thumb=(600, 340)):
        self.dir = Path(sequence_dir)
        names = sorted(os.listdir(self.dir / "results"))
        self.rgb_files = [f for f in names if f.startswith("frame")]
        self.depth_files = [f for f in names if f.startswith("depth")]
        self.thumb = thumb

        self.length = len(self.rgb_files)
        if seq_len > 0:
            self.length = min(self.length, seq_len)

        c2w = np.loadtxt(self.dir / "traj.txt").astype(np.float64).reshape(-1, 4, 4)
        self.poses_w2c = np.linalg.inv(c2w).astype(np.float32)

        # intrinsics of the thumbnailed resolution
        K = np.array([[300.0, 0, 299.75], [0, 300.0, 169.75], [0, 0, 1]], np.float32)
        self._K = K
        self.camera = None  # determined from the first decoded frame

    def init(self):
        return

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        from PIL import Image as PILImage

        if idx >= self.length:
            raise IndexError(idx)
        rgb_path = self.dir / "results" / self.rgb_files[idx]
        im = PILImage.open(rgb_path)
        im.thumbnail(self.thumb, PILImage.Resampling.LANCZOS)
        img = np.float32(np.asarray(im)) / 255.0
        h, w = img.shape[:2]
        if self.camera is None:
            self.camera = Camera(K=torch.from_numpy(self._K), height=h, width=w)

        depth_path = self.dir / "results" / self.depth_files[idx]
        depth_full = np.asarray(PILImage.open(depth_path)).astype(np.float32) / 5000.0
        # nearest-resize depth to the thumbnailed RGB resolution
        ys = (np.arange(h) * depth_full.shape[0] / h).astype(int)
        xs = (np.arange(w) * depth_full.shape[1] / w).astype(int)
        depth = depth_full[np.ix_(ys, xs)]

        return Frame(
            image=img,
            timestamp=float(idx) / 30.0,
            camera=self.camera,
            index=idx,
            gt_pose=self.poses_w2c[idx],
            gt_depth=depth,
            img_file=str(rgb_path),
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
