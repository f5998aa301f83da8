"""Materialized dataset cache: any dataset saved to / loaded from one .npz.

Counterpart of gslam_tpu/io/npz.py, in the same file format, so a file that
either package writes, the other reads. Frames are generated once (a
raytraced or splat-rendered sequence, or frames decoded from disk) and the
SLAM process streams them from a pure-numpy `NpzDataset`.
"""

from __future__ import annotations

import numpy as np
import torch

from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.io.frames import Frame


def save_dataset_npz(dataset, path) -> None:
    """Materialize any Frame-iterable dataset (images, gt depths/poses,
    intrinsics) into a single compressed .npz."""
    imgs, depths, poses, stamps = [], [], [], []
    for f in iter(dataset):
        imgs.append(np.asarray(f.image, np.float32))
        depths.append(
            np.asarray(f.gt_depth, np.float32) if f.gt_depth is not None
            else np.zeros(f.image.shape[:2], np.float32))
        poses.append(
            np.asarray(f.gt_pose, np.float32) if f.gt_pose is not None
            else np.full((4, 4), np.nan, np.float32))
        stamps.append(f.timestamp)
    cam = dataset.camera if dataset.camera is not None else dataset[0].camera
    np.savez_compressed(
        path,
        images=np.stack(imgs),
        depths=np.stack(depths),
        gt_poses=np.stack(poses),
        timestamps=np.asarray(stamps, np.float64),
        K=torch.as_tensor(cam.K).cpu().numpy().astype(np.float32),
        hw=np.asarray([cam.height, cam.width], np.int32),
        has_depth=np.asarray(
            [getattr(dataset, "with_depth", True)], bool),
    )


class NpzDataset:
    """Pure-numpy dataset over a file written by `save_dataset_npz`."""

    def __init__(self, path, seq_len: int = -1):
        d = np.load(path)
        self.images = d["images"]
        self.depths = d["depths"]
        self.gt_poses = d["gt_poses"]
        self.timestamps = d["timestamps"]
        h, w = (int(x) for x in d["hw"])
        self.camera = Camera(K=torch.from_numpy(d["K"]), height=h, width=w)
        self.with_depth = bool(d["has_depth"][0])
        n = self.images.shape[0]
        self.length = n if seq_len <= 0 else min(seq_len, n)

    def init(self):
        return

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        if idx >= self.length:
            raise IndexError(idx)
        gt_pose = self.gt_poses[idx]
        return Frame(
            image=self.images[idx],
            timestamp=float(self.timestamps[idx]),
            camera=self.camera,
            index=idx,
            gt_pose=None if np.isnan(gt_pose).any() else gt_pose,
            gt_depth=self.depths[idx] if self.with_depth else None,
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
