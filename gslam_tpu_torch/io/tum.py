"""TUM-RGBD sequence loader.

Counterpart of gslam_tpu/io/tum.py: rgb.txt/depth.txt/groundtruth.txt
parsing with nearest-timestamp association, the per-sequence intrinsics and
distortion table, cv2 undistortion maps and depth scaling (/5000). Frames
are decoded and undistorted by the native loader (io/native.py), with a
PIL + cv2 fallback. cv2 is imported when a dataset is built, not with the
module.

TUM ground truth is camera-to-world; it is converted to world-to-camera at
load, the convention of every pose in the pipeline.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

import torch

from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.io.frames import Frame

# fx, fy, cx, cy, then 5 distortion coefficients (k1 k2 p1 p2 k3)
TUM_INTRINSICS = {
    "freiburg1": [517.3, 516.5, 318.6, 255.3, 0.2624, -0.9531, -0.0054, 0.0026, 1.1633],
    "freiburg2": [520.9, 521.0, 325.1, 249.7, 0.2312, -0.7849, -0.0033, -0.0001, 0.9172],
    "freiburg3": [535.4, 539.2, 320.1, 247.6, 0.0, 0.0, 0.0, 0.0, 0.0],
}


def _quat_xyzw_to_matrix(q: np.ndarray) -> np.ndarray:
    import scipy.spatial.transform as sst

    return sst.Rotation.from_quat(q).as_matrix()


def _read_list_file(path: Path) -> tuple[np.ndarray, list[str]]:
    stamps, names = [], []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        stamps.append(float(parts[0]))
        names.append(parts[1])
    return np.asarray(stamps, np.float64), names


class TumRGBDataset:
    def __init__(self, sequence_dir, seq_len: int = -1, downscale: int = 1):
        import cv2

        self.dir = Path(sequence_dir)
        self.rgb_stamps, self.rgb_files = _read_list_file(self.dir / "rgb.txt")
        self.depth_stamps, self.depth_files = _read_list_file(self.dir / "depth.txt")

        gt = np.loadtxt(self.dir / "groundtruth.txt", comments="#")
        gt_stamps, gt_vals = gt[:, 0], gt[:, 1:]

        # associate each rgb frame with its nearest gt pose and depth frame
        nearest_gt = np.abs(
            self.rgb_stamps[:, None] - gt_stamps[None, :]
        ).argmin(axis=1)
        self.nearest_depth = np.abs(
            self.rgb_stamps[:, None] - self.depth_stamps[None, :]
        ).argmin(axis=1)

        t = gt_vals[nearest_gt, :3]
        q = gt_vals[nearest_gt, 3:7]  # xyzw
        rot = _quat_xyzw_to_matrix(q)
        c2w = np.tile(np.eye(4), (len(self.rgb_stamps), 1, 1))
        c2w[:, :3, :3] = rot
        c2w[:, :3, 3] = t
        self.poses_w2c = np.linalg.inv(c2w).astype(np.float32)

        self.length = len(self.rgb_files)
        if seq_len > 0:
            self.length = min(self.length, seq_len)

        seq_kind = str(self.dir.name).split("_")[2]
        fx, fy, cx, cy, *dist = TUM_INTRINSICS[seq_kind]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        size = (640, 480)
        self.new_K, self.roi = cv2.getOptimalNewCameraMatrix(
            K, np.asarray(dist), size, 0, size
        )
        self.map_x, self.map_y = cv2.initUndistortRectifyMap(
            K, np.asarray(dist), None, self.new_K, size, cv2.CV_32FC1
        )
        self.downscale = downscale
        x, y, w, h = self.roi
        self.out_w, self.out_h = w // downscale, h // downscale

        Kc = self.new_K.copy()
        Kc[:2] /= downscale
        self.camera = Camera(K=torch.from_numpy(Kc.astype(np.float32)),
                             height=self.out_h, width=self.out_w)

    def init(self):
        return

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        if idx >= self.length:
            raise IndexError(idx)
        rgb_path = self.dir / self.rgb_files[idx]
        depth_path = self.dir / self.depth_files[self.nearest_depth[idx]]
        x, y, w, h = self.roi

        # native C++ decode+undistort (GIL-free); PIL/cv2 fallback
        from gslam_tpu_torch.io import native

        img01 = native.load_rgb_remap(
            rgb_path, self.map_x, self.map_y, (x, y, w, h)
        )
        depth = native.load_depth(depth_path, (x, y, w, h))
        if img01 is None or depth is None:
            import cv2
            from PIL import Image as PILImage

            img = np.asarray(PILImage.open(rgb_path))
            img = cv2.remap(img, self.map_x, self.map_y, cv2.INTER_LINEAR)
            img01 = np.float32(img[y : y + h, x : x + w]) / 255.0
            d = np.asarray(PILImage.open(depth_path)).astype(np.float32)
            depth = d[y : y + h, x : x + w] / 5000.0
        img = img01

        if self.downscale > 1:
            import cv2

            img = cv2.resize(
                img, (self.out_w, self.out_h), interpolation=cv2.INTER_AREA
            )
            depth = cv2.resize(
                depth, (self.out_w, self.out_h), interpolation=cv2.INTER_NEAREST
            )

        return Frame(
            image=np.float32(img),
            timestamp=float(self.rgb_stamps[idx]),
            camera=self.camera,
            index=idx,
            gt_pose=self.poses_w2c[idx],
            gt_depth=depth,
            img_file=str(rgb_path),
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
