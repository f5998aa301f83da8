"""Fixed-capacity device-resident keyframe store.

Counterpart of gslam_tpu/mapping/keyframes.py: a keyframe is a row of
fixed-shape tensors (image, optional ground-truth depth, the learnable pose
delta over a frozen base, exposure, the latest rendered depth). The host
chooses the slots; the tensors stay on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gslam_tpu_torch import resolve_device
from gslam_tpu_torch.core.transforms import PoseDelta, pose_matrix


class KeyframeStore(NamedTuple):
    images: torch.Tensor  # [K, H, W, 3]
    gt_depths: torch.Tensor  # [K, H, W] (zeros when not RGB-D)
    pose_base: torch.Tensor  # [K, 4, 4]
    d_rot6: torch.Tensor  # [K, 6] learnable
    d_t: torch.Tensor  # [K, 3] learnable
    exposures: torch.Tensor  # [K, 2] frozen (estimated by the frontend)
    est_depths: torch.Tensor  # [K, H, W] latest rendered depth per keyframe
    frame_idx: torch.Tensor  # [K] int32 source frame index (-1 = empty)
    mask: torch.Tensor  # [K] bool slot occupancy

    @property
    def capacity(self) -> int:
        return self.images.shape[0]

    def poses(self) -> torch.Tensor:
        """[K, 4, 4] current world-to-camera matrices."""
        return pose_matrix(PoseDelta(self.pose_base, self.d_rot6, self.d_t))


_DTYPES = {"frame_idx": np.int32, "mask": np.bool_}


def empty_keyframes(capacity: int, height: int, width: int,
                    device: str | torch.device | None = None) -> KeyframeStore:
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return KeyframeStore(
        images=torch.zeros((capacity, height, width, 3), **f32),
        gt_depths=torch.zeros((capacity, height, width), **f32),
        pose_base=torch.eye(4, **f32).repeat(capacity, 1, 1),
        d_rot6=torch.zeros((capacity, 6), **f32),
        d_t=torch.zeros((capacity, 3), **f32),
        exposures=torch.zeros((capacity, 2), **f32),
        est_depths=torch.zeros((capacity, height, width), **f32),
        frame_idx=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        mask=torch.zeros((capacity,), dtype=torch.bool, device=dev),
    )


def add_keyframe(
    store: KeyframeStore,
    slot: int,
    image,
    pose,
    exposure,
    frame_index: int,
    gt_depth=None,
    est_depth=None,
) -> KeyframeStore:
    """Write a keyframe into `slot` (host-chosen), resetting its pose delta.
    Returns a new store; the given one is left as it was."""

    def put(field, value):
        x = getattr(store, field).clone()
        x[slot] = torch.as_tensor(value, dtype=x.dtype).to(x.device)
        return x

    s = store._replace(
        images=put("images", image),
        pose_base=put("pose_base", pose),
        d_rot6=put("d_rot6", 0.0),
        d_t=put("d_t", 0.0),
        exposures=put("exposures", exposure),
        frame_idx=put("frame_idx", frame_index),
        mask=put("mask", True),
    )
    if gt_depth is not None:
        s = s._replace(gt_depths=put("gt_depths", gt_depth))
    if est_depth is not None:
        s = s._replace(est_depths=put("est_depths", est_depth))
    return s


def keyframes_to_numpy(store: KeyframeStore) -> dict[str, np.ndarray]:
    return {f: x.detach().cpu().numpy() for f, x in zip(KeyframeStore._fields, store)}


def keyframes_from_numpy(d: dict, device: str | torch.device | None = None
                         ) -> KeyframeStore:
    """A store from the fields as numpy arrays (the JAX store's or
    keyframes_to_numpy's)."""
    dev = resolve_device(device)
    return KeyframeStore(**{
        f: torch.from_numpy(np.array(d[f], dtype=_DTYPES.get(f, np.float32))).to(dev)
        for f in KeyframeStore._fields})
