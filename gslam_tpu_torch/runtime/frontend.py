"""Tracking frontend actor.

Counterpart of gslam_tpu/runtime/frontend.py: pin the first frame at
identity (the caller then sends REQUEST_INIT), predict each later frame
with the constant-motion prior, refine pose and exposure against the latest
synced map snapshot (igs through `track_frame`, or dense warp alignment
against the synced keyframe render when `method="warp"` and one has been
synced), apply the innovation-scaled plausibility gate, and keep the
estimated trajectory. Poses cross the actor boundary as numpy; tracking
runs on the frontend's device.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from gslam_tpu_torch import resolve_device, to_device
from gslam_tpu_torch.io.frames import Frame
from gslam_tpu_torch.runtime.messages import SyncPayload
from gslam_tpu_torch.tracking.track import (
    TrackingConfig, constant_motion_prior, track_frame,
)
from gslam_tpu_torch.tracking.warp import warp_track
from gslam_tpu_torch.viz.visualization import NullSink

logger = logging.getLogger("gslam_tpu_torch.frontend")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class FrontendActor:
    def __init__(self, cfg: TrackingConfig, width: int, height: int, sink=None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.width, self.height = width, height
        self.device = resolve_device(device)
        self.gmap = None  # latest synced snapshot
        self.keyframe_poses: dict[int, np.ndarray] = {}
        self.pose_graph: dict[int, set] = {}
        self.reference_depth = None
        self.reference_rgb = None
        self.reference_alpha = None
        self.reference_pose = None
        self.frames: list[Frame] = []
        self.track_times: list[float] = []
        self.losses: list[float] = []
        # cumulative count of guard-rejected tracks (FusedState.health's
        # semantics)
        self.health = 0
        self._innov_ema = 0.0  # accepted-innovation EMA (guard gauge)
        self._consec_rej = 0  # consecutive rejections (guard bound growth)
        self.evals: list[int] = []
        self.sink = sink if sink is not None else NullSink()

    def apply_sync(self, payload: SyncPayload):
        self.gmap = payload.gmap
        self.keyframe_poses = payload.keyframe_poses
        self.pose_graph = payload.pose_graph
        self.reference_depth = payload.reference_depth
        self.reference_rgb = payload.reference_rgb
        self.reference_alpha = payload.reference_alpha
        self.reference_pose = payload.reference_pose
        self.sink.log_splats(payload.gmap)

    def predict_pose(self) -> np.ndarray:
        if len(self.frames) == 0:
            return np.eye(4, dtype=np.float32)
        if len(self.frames) == 1:
            return self.frames[-1].est_pose
        a = torch.as_tensor(self.frames[-2].est_pose, dtype=torch.float32)
        b = torch.as_tensor(self.frames[-1].est_pose, dtype=torch.float32)
        return constant_motion_prior(a, b).numpy()

    def track(self, frame: Frame) -> Frame:
        """Refine the frame's pose against the synced map. The first frame
        is pinned at identity (the caller must REQUEST_INIT)."""
        if len(self.frames) == 0 or self.gmap is None:
            frame.est_pose = np.eye(4, dtype=np.float32)
            frame.exposure = np.zeros(2, np.float32)
            self.frames.append(frame.strip())
            return frame

        dev = self.device
        t0 = time.perf_counter()
        prior = self.predict_pose()
        init_exposure = to_device(self.frames[-1].exposure, dev)
        gt_depth = (frame.gt_depth if (self.cfg.use_gt_depths and frame.gt_depth is not None)
                    else None)
        use_warp = (self.cfg.method == "warp" and self.reference_depth is not None
                    and self.reference_rgb is not None and self.reference_pose is not None)
        if use_warp:
            # dense warp alignment against the synced keyframe render
            pose, exposure, loss = warp_track(
                to_device(self.reference_pose, dev), to_device(prior, dev),
                self.reference_rgb, self.reference_depth, to_device(frame.image, dev),
                to_device(frame.camera.K, dev), init_exposure, self.cfg,
                ref_alpha=self.reference_alpha)
            frame.est_pose = _np(pose)
            frame.exposure = _np(exposure)
            final_loss = float(loss)
        else:
            res = track_frame(self.gmap, prior, init_exposure, frame.image, frame.camera.K,
                              self.width, self.height, self.cfg, gt_depth=gt_depth,
                              device=dev)
            est_pose = _np(torch.as_tensor(res.pose))
            rejected = bool(res.rejected)
            # innovation-scaled plausibility gate (the fused step's twin): a
            # refined pose whose translation off the motion prior exceeds
            # several times the typical accepted innovation, or whose
            # rotation off the prior exceeds guard_max_rot, is a basin jump;
            # the bound grows with consecutive rejections, so a genuine
            # re-lock correction is accepted
            delta = est_pose @ np.linalg.inv(np.asarray(prior))
            innov = float(np.linalg.norm(delta[:3, 3]))
            if self.cfg.guard_innov_mult > 0.0 and not rejected and len(self.frames) >= 3:
                cos_rot = (float(np.trace(delta[:3, :3])) - 1.0) * 0.5
                bound = (max(self.cfg.guard_innov_mult * self._innov_ema,
                             self.cfg.guard_step_floor)
                         + self._consec_rej * max(2.0 * self._innov_ema,
                                                  0.5 * self.cfg.guard_step_floor))
                if innov > bound or cos_rot < np.cos(self.cfg.guard_max_rot):
                    logger.warning(
                        "frame %d guard: innov=%.4f bound=%.4f (ema=%.4f consec=%d) "
                        "cos_rot=%.4f (limit %.4f)", frame.index, innov, bound,
                        self._innov_ema, self._consec_rej, cos_rot,
                        float(np.cos(self.cfg.guard_max_rot)))
                    est_pose = np.asarray(prior)
                    rejected = True
            if rejected:
                self._consec_rej += 1
            else:
                self._consec_rej = 0
                self._innov_ema = (innov if self._innov_ema == 0.0
                                   else 0.8 * self._innov_ema + 0.2 * innov)
            frame.est_pose = est_pose
            frame.exposure = _np(torch.as_tensor(res.exposure))
            final_loss = float(res.loss)
            self.health += int(rejected)
            frame.rejected = rejected
            self.evals.append(int(res.n_evals))
            if rejected:
                logger.warning("frame %d: tracking guard rejected the refined pose "
                               "(falling back to the motion prior); health=%d",
                               frame.index, self.health)
        dt = time.perf_counter() - t0
        self.track_times.append(dt)
        self.losses.append(final_loss)
        self._log_frame(frame, final_loss, dt)
        self.frames.append(frame.strip())
        return frame

    def _log_frame(self, frame: Frame, loss: float, dt: float):
        """Stream per-frame telemetry; image sinks get a fresh render of the
        final pose."""
        rendered = depth = beta = None
        if self.sink.wants_images and self.gmap is not None:
            from gslam_tpu_torch.ops.rasterize import render

            with torch.no_grad():
                out = render(**self.gmap.render_kwargs(), viewmats=frame.est_pose[None],
                             Ks=to_device(frame.camera.K, self.device)[None],
                             width=self.width, height=self.height, cfg=self.cfg.render,
                             device=self.device)
            rendered, depth, beta = _np(out.rgb[0]), _np(out.depth[0]), _np(out.beta[0])
        self.sink.log_frame(frame, rendered=rendered, depth=depth, beta=beta,
                            loss=loss, tracking_time=dt)

    def trajectory(self) -> tuple[np.ndarray, np.ndarray]:
        """(gt_positions, est_positions) camera centers of the frames with a
        ground-truth pose and a finite estimate."""
        from gslam_tpu_torch.eval.trajectory import trajectory_positions

        gt, est = [], []
        for f in self.frames:
            if (f.gt_pose is not None and f.est_pose is not None
                    and np.isfinite(f.est_pose).all()):
                gt.append(f.gt_pose)
                est.append(f.est_pose)
        if not gt:
            return np.zeros((0, 3)), np.zeros((0, 3))
        return trajectory_positions(np.asarray(gt)), trajectory_positions(np.asarray(est))
