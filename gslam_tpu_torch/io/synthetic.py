"""Synthetic splat-scene dataset.

Counterpart of gslam_tpu/io/synthetic.py: ground-truth RGB(+depth) frames
rendered by the port's own renderer from a random Gaussian "room" along a
smooth random-walk trajectory, with exact ground-truth poses. The scene and
the trajectory are numpy, drawn in the JAX package's order from
`np.random.default_rng(seed)`, so both packages build the same scene from
the same seed; the renders differ only by float32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from gslam_tpu_torch import resolve_device
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.core.transforms import so3_exp
from gslam_tpu_torch.io.frames import Frame
from gslam_tpu_torch.ops.rasterize import RenderConfig, render


def make_room_scene(rng, n_splats, extent=3.0):
    """Random colorful splats on the inside of a box ('room') around origin."""
    # sample points on 5 walls of a box (no wall behind the camera start)
    wall = rng.integers(0, 5, n_splats)
    u = rng.uniform(-1, 1, n_splats)
    v = rng.uniform(-1, 1, n_splats)
    pts = np.zeros((n_splats, 3), np.float32)
    e = extent
    pts[wall == 0] = np.stack([u, v, np.full_like(u, 1.0)], -1)[wall == 0] * e  # front
    pts[wall == 1] = np.stack([np.full_like(u, -1.0), u, v * 0.5 + 0.5], -1)[wall == 1] * e
    pts[wall == 2] = np.stack([np.full_like(u, 1.0), u, v * 0.5 + 0.5], -1)[wall == 2] * e
    pts[wall == 3] = np.stack([u, np.full_like(u, -1.0), v * 0.5 + 0.5], -1)[wall == 3] * e
    pts[wall == 4] = np.stack([u, np.full_like(u, 1.0), v * 0.5 + 0.5], -1)[wall == 4] * e
    # bumpy surfaces
    pts += rng.normal(scale=0.05 * e, size=pts.shape).astype(np.float32)
    return pts


class SyntheticDataset:
    def __init__(
        self,
        seq_len: int = 30,
        width: int = 160,
        height: int = 120,
        n_splats: int = 2000,
        seed: int = 0,
        motion_scale: float = 0.02,
        with_depth: bool = True,
        rotation_only: bool = False,
        device: str | torch.device | None = None,
    ):
        """Renders the sequence on `device` (CUDA unless the caller names
        one); the frames are kept as numpy."""
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        fx = fy = 0.9 * width
        K = np.array([[fx, 0, width / 2], [0, fy, height / 2], [0, 0, 1]], np.float32)
        self.camera = Camera(K=torch.from_numpy(K), height=height, width=width)
        self.length = seq_len

        pts = make_room_scene(rng, n_splats)
        scale = rng.uniform(0.05, 0.14, (n_splats, 3)).astype(np.float32)
        self.gt_map_fields = dict(
            means=pts,
            quats=rng.normal(size=(n_splats, 4)).astype(np.float32),
            log_scales=np.log(scale),
            logit_opacities=np.full((n_splats,), 3.0, np.float32),
            logit_colors=rng.normal(size=(n_splats, 3)).astype(np.float32) * 1.5,
            log_uncertainties=np.zeros((n_splats,), np.float32),
            alive=np.ones((n_splats,), bool),
        )

        # smooth random-walk trajectory (world-to-camera poses)
        poses = [np.eye(4, dtype=np.float32)]
        vel = np.zeros(3, np.float32)
        rot_vel = np.zeros(3, np.float32)
        for _ in range(seq_len - 1):
            if rotation_only:
                # steady pan in place at motion_scale rad/frame: only the
                # view-angle keyframe trigger can fire
                vel = np.zeros(3, np.float32)
                rot_vel = np.asarray([0.0, motion_scale, 0.0], np.float32)
            else:
                vel = 0.9 * vel + rng.normal(scale=motion_scale, size=3) * [1, 1, 0.5]
                rot_vel = 0.9 * rot_vel + rng.normal(scale=motion_scale * 0.3, size=3)
            delta = np.eye(4, dtype=np.float32)
            delta[:3, :3] = so3_exp(torch.as_tensor(rot_vel, dtype=torch.float32)).numpy()
            delta[:3, 3] = vel
            poses.append((delta @ poses[-1]).astype(np.float32))
        self.poses = np.stack(poses)  # world-to-camera

        cfg = RenderConfig(tile_capacity=512, pairs_per_gaussian=16)
        # render in camera batches of at most 8 VGA frames' worth of pixels
        batch = max(1, min(seq_len, (8 * 640 * 480) // (width * height)))
        imgs, deps = [], []
        with torch.no_grad():
            for c0 in range(0, seq_len, batch):
                vm = torch.from_numpy(self.poses[c0:c0 + batch])
                out = render(**self.gt_map_fields, viewmats=vm,
                             Ks=torch.from_numpy(K)[None].expand(vm.shape[0], 3, 3),
                             width=width, height=height, cfg=cfg, device=dev)
                imgs.append(np.clip(out.rgb.cpu().numpy(), 0.0, 1.0))
                if with_depth:
                    deps.append(out.depth.cpu().numpy())
        self.images = np.concatenate(imgs, axis=0)
        self.depths = np.concatenate(deps, axis=0) if with_depth else None
        self.with_depth = with_depth

    def init(self):
        return

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        if idx >= self.length:
            raise IndexError(idx)
        return Frame(
            image=self.images[idx],
            timestamp=float(idx) / 30.0,
            camera=self.camera,
            index=idx,
            gt_pose=self.poses[idx],
            gt_depth=self.depths[idx] if self.with_depth else None,
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
