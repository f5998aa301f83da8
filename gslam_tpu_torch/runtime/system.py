"""SLAM system orchestrator: the actor runtime.

Counterpart of gslam_tpu/runtime/system.py. It wires sensor -> frontend ->
backend with the actor message protocol, in two modes:
  * synchronous=True: a fixed interleaving per frame (track, keyframe and
    map, idle optimization, periodic sync); tests and evaluation runs;
  * synchronous=False: a sensor thread, the frontend on the calling thread
    and a backend thread that optimizes while idle, with queue-based
    messages. Both threads use one device and its default stream.
`finalize` scores the run: ATE against the ground truth, PSNR/SSIM of
re-rendered frames, per-phase host times (the recorder's backend.* spans,
runtime/trace.py), the divergence counters; with a
run directory it writes `metrics.json`, `splats.npz`, `traj.png` and
`trajectory.npy`, the estimated world-to-camera poses as [N, 4, 4] (the
fused runtime's format).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import threading
import time
from pathlib import Path

import numpy as np
import torch

from gslam_tpu_torch import resolve_device, to_device
from gslam_tpu_torch.mapping.backend_ops import MapConfig
from gslam_tpu_torch.runtime import trace
from gslam_tpu_torch.runtime.backend import BackendActor
from gslam_tpu_torch.runtime.checkpoint import save_checkpoint, save_map
from gslam_tpu_torch.runtime.frontend import FrontendActor
from gslam_tpu_torch.runtime.messages import FrontendMessage
from gslam_tpu_torch.tracking.track import TrackingConfig
from gslam_tpu_torch.viz.visualization import make_sink

logger = logging.getLogger("gslam_tpu_torch.system")

PHASE = "backend."  # the backend's phase spans: backend.map, backend.insert, ...


def _phase_spans() -> dict:
    """The recorder's aggregates of the backend's phase spans, by phase."""
    return {k[len(PHASE):]: v for k, v in trace.snapshot()["spans"].items()
            if k.startswith(PHASE)}


@dataclasses.dataclass
class SlamConfig:
    tracking: TrackingConfig = TrackingConfig()
    mapping: MapConfig = MapConfig()
    capacity: int = 2**17
    kf_capacity: int = 64
    sync_every: int = 5  # frames between map syncs
    synchronous: bool = True
    idle_opt_per_frame: int = 1  # idle optimization slices per frame (sync mode)
    checkpoint_every: int = 0  # frames; 0 = only at end
    # abort once this many tracks were guard-rejected (0 disables)
    abort_unhealthy: int = 4
    eval_stride: int = 1  # evaluate PSNR on every k-th frame at the end
    telemetry: str = "null"  # 'null' | 'disk' | 'rerun' | 'auto'
    seed: int = 0
    run_dir: str | None = None


class SlamSystem:
    def __init__(self, cfg: SlamConfig, width: int, height: int,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.run_dir = Path(cfg.run_dir) if cfg.run_dir else None
        if self.run_dir:
            self.run_dir.mkdir(parents=True, exist_ok=True)
        self.sink = make_sink(cfg.telemetry, run_dir=self.run_dir,
                              run_name=self.run_dir.name if self.run_dir else "gslam_tpu")
        self.frontend = FrontendActor(cfg.tracking, width, height, sink=self.sink,
                                      device=self.device)
        self.backend = BackendActor(cfg.mapping, width, height, capacity=cfg.capacity,
                                    kf_capacity=cfg.kf_capacity, seed=cfg.seed,
                                    device=self.device)
        self.width, self.height = width, height
        self.n_keyframes_added = 0
        self.start_index = 0  # set by checkpoint.restore_system on resume
        self._phases0 = _phase_spans()  # finalize reports the phases run since

    # ------------- synchronous pipeline -------------

    def _process_frame_sync(self, frame):
        fe, be = self.frontend, self.backend
        if len(fe.frames) == 0:
            frame = fe.track(frame)  # pins identity
            be.handle_request_init(frame, frame.est_pose, frame.exposure)
            fe.apply_sync(be.sync_payload())
            return
        frame = fe.track(frame)
        self._check_health(frame.index)
        if be.handle_add_frame(frame, frame.est_pose, frame.exposure):
            self.n_keyframes_added += 1
        for _ in range(self.cfg.idle_opt_per_frame):
            be.idle_step()
        if frame.index % self.cfg.sync_every == 0:
            fe.apply_sync(be.sync_payload())

    def run(self, dataset) -> dict:
        """Run SLAM over a dataset; returns the metrics dict."""
        t_start = time.time()
        self._dataset = dataset
        if self.cfg.synchronous:
            for frame in iter(dataset):
                if frame.index < self.start_index:
                    continue  # already processed before the resume
                self._process_frame_sync(frame)
                if (self.cfg.checkpoint_every and self.run_dir
                        and frame.index % self.cfg.checkpoint_every == 0 and frame.index > 0):
                    save_checkpoint(self.run_dir / "checkpoint.npz", self)
        else:
            self._run_threaded(dataset)
        wall = time.time() - t_start
        # END_SYNC: the frontend adopts the final map
        self.frontend.apply_sync(self.backend.sync_payload())
        return self.finalize(wall)

    # ------------- threaded pipeline -------------

    def _run_threaded(self, dataset):
        from gslam_tpu_torch.io.stream import SensorStream

        fe, be = self.frontend, self.backend
        to_backend: queue.Queue = queue.Queue()
        sync_box: queue.Queue = queue.Queue()
        done = threading.Event()
        failure = []

        def backend_loop():
            try:
                while not done.is_set() or not to_backend.empty():
                    try:
                        msg = to_backend.get(timeout=0.01)
                    except queue.Empty:
                        if not be.pause_map_optim and be.kf_order:
                            be.idle_step()
                        continue
                    if msg is None:
                        break
                    kind, frame, pose, exposure = msg
                    if kind == FrontendMessage.REQUEST_INIT:
                        be.handle_request_init(frame, pose, exposure)
                        sync_box.put(be.sync_payload())
                    elif kind == FrontendMessage.ADD_FRAME:
                        if be.handle_add_frame(frame, pose, exposure):
                            self.n_keyframes_added += 1
                        if frame.index % self.cfg.sync_every == 0:
                            sync_box.put(be.sync_payload())
            except BaseException as e:  # handed to the frontend thread, re-raised there
                failure.append(e)
                sync_box.put(None)
                raise

        def apply(payload):
            if payload is None:
                raise RuntimeError("the backend thread failed") from failure[0]
            fe.apply_sync(payload)

        def drain():
            try:
                while True:
                    apply(sync_box.get_nowait())
            except queue.Empty:
                pass

        bt = threading.Thread(target=backend_loop, daemon=True)
        bt.start()
        stream = SensorStream(dataset).start()
        try:
            while True:
                drain()
                frame = stream.get()
                if frame is None:
                    to_backend.put(None)
                    break
                if frame.index < self.start_index:
                    continue
                frame = fe.track(frame)
                self._check_health(frame.index)
                # a sync that landed while tracking serves the next frame
                drain()
                kind = (FrontendMessage.REQUEST_INIT if len(fe.frames) == 1
                        else FrontendMessage.ADD_FRAME)
                to_backend.put((kind, frame, frame.est_pose, frame.exposure))
                if kind == FrontendMessage.REQUEST_INIT:
                    # block until the map exists
                    apply(sync_box.get())
        finally:
            stream.stop()
            done.set()
        bt.join(timeout=600.0)
        if failure:
            raise RuntimeError("the backend thread failed") from failure[0]
        if bt.is_alive():
            raise RuntimeError("backend thread failed to finish within 600 s; metrics would "
                               "reflect a partially-optimized map")

    def _check_health(self, frame_index: int):
        """Abort once too many tracks were guard-rejected: a run past that
        point only produces a trajectory that looks like a result."""
        h = self.frontend.health
        if self.cfg.abort_unhealthy and h >= self.cfg.abort_unhealthy:
            raise RuntimeError(
                f"aborting: health counter reached {h} (>= {self.cfg.abort_unhealthy}) at "
                f"frame {frame_index}: tracking has diverged")

    # ------------- evaluation / teardown -------------

    def finalize(self, wall_time: float) -> dict:
        from gslam_tpu_torch.eval.metrics import sanitize_metrics
        from gslam_tpu_torch.eval.trajectory import ate_mean, ate_rmse, plot_trajectories
        from gslam_tpu_torch.mapping.backend_ops import eval_views

        fe, be = self.frontend, self.backend
        metrics = {
            "N": be.n_live_splats(),
            "C": len(be.kf_order),
            "L": len(fe.frames),
            "wall_time_s": wall_time,
        }
        if fe.track_times:
            metrics["mean_track_ms"] = float(np.mean(fe.track_times) * 1e3)
            metrics["tracking_fps"] = float(1.0 / np.mean(fe.track_times))
            if len(fe.track_times) > 3:
                # steady state: skip the first frames, which pay the kernel build
                steady = fe.track_times[3:]
                metrics["steady_track_ms"] = float(np.mean(steady) * 1e3)
                metrics["steady_tracking_fps"] = float(1.0 / np.mean(steady))
        nonfinite = sum(1 for f in fe.frames
                        if f.est_pose is None or not np.isfinite(f.est_pose).all())
        metrics["health"] = fe.health
        metrics["nonfinite_poses"] = nonfinite
        # a recovered guard rejection is not divergence: the run is diverged
        # only when rejections reached the abort threshold or a pose went
        # non-finite
        metrics["diverged"] = bool(
            nonfinite > 0 or (fe.health >= self.cfg.abort_unhealthy
                              if self.cfg.abort_unhealthy else fe.health > 0))
        if fe.evals:
            metrics["mean_track_evals"] = float(np.mean(fe.evals))
        if be.refine_evals:
            metrics["mean_refine_evals"] = float(np.mean(be.refine_evals))
        metrics["max_pairs_seen"] = be.max_pairs_seen
        metrics["n_pair_overflows"] = be.n_pair_overflows
        # per-phase host time: the backend's spans since this system was made
        phases = {}
        for k, v in sorted(_phase_spans().items()):
            v0 = self._phases0.get(k, {"calls": 0, "total_s": 0.0})
            if v["calls"] > v0["calls"]:
                phases[k] = (v["calls"] - v0["calls"], v["total_s"] - v0["total_s"])
        metrics["phase_ms"] = {k: round(1e3 * s / n, 2) for k, (n, s) in phases.items()}
        metrics["phase_total_s"] = {k: round(s, 2) for k, (n, s) in phases.items()}
        metrics["phase_calls"] = {k: n for k, (n, s) in phases.items()}

        gt_t, est_t = fe.trajectory()
        if len(gt_t) >= 2:
            metrics["ate"] = ate_mean(gt_t, est_t)
            metrics["ate_rmse"] = ate_rmse(gt_t, est_t)
            if self.run_dir:
                try:
                    plot_trajectories(gt_t, est_t, self.run_dir / "traj.png",
                                      sorted(be.frame_slot.keys()))
                except ImportError as e:  # a host without matplotlib: no traj.png
                    logger.warning("traj.png not written: %s", e)
        if self.run_dir and fe.frames:
            eye = np.eye(4, dtype=np.float32)
            np.save(self.run_dir / "trajectory.npy",
                    np.stack([eye if f.est_pose is None else np.asarray(f.est_pose, np.float32)
                              for f in fe.frames]))

        # re-render every k-th tracked frame from the final map, `batch`
        # real views per render
        eval_frames = [f for f in fe.frames[:: self.cfg.eval_stride] if f.est_pose is not None]
        psnrs, ssims = [], []
        batch = 16
        pairs = list(self._eval_images(eval_frames))
        for c0 in range(0, len(pairs), batch):
            chunk = pairs[c0:c0 + batch]
            ps, ss = eval_views(
                be.gmap,
                to_device(np.stack([np.asarray(f.est_pose, np.float32) for f, _ in chunk]),
                          self.device),
                to_device(np.stack([np.asarray(img, np.float32) for _, img in chunk]),
                          self.device),
                be.K, self.width, self.height, self.cfg.mapping)
            psnrs.extend(ps.tolist())
            ssims.extend(ss.tolist())
        if psnrs:
            metrics["psnr"] = float(np.mean(psnrs))
            metrics["ssim"] = float(np.mean(ssims))

        if self.run_dir:
            save_map(self.run_dir / "splats.npz", be.gmap)
            with open(self.run_dir / "metrics.json", "w") as f:
                json.dump(sanitize_metrics(metrics), f, indent=2)
        logger.info("metrics: %s", metrics)
        return metrics

    def _eval_images(self, frames):
        """Yield (frame, gt_image) pairs; images come from the dataset when
        the stripped frame dropped them, or from disk."""
        dataset = getattr(self, "_dataset", None)
        for f in frames:
            if f.image is not None:
                yield f, f.image
            elif dataset is not None:
                try:
                    yield f, dataset[f.index].image
                except IndexError:  # the dataset is shorter than the trajectory
                    continue
            elif f.img_file is not None:
                from PIL import Image as PILImage

                img = np.float32(PILImage.open(f.img_file)) / 255.0
                if img.shape[:2] == (self.height, self.width):
                    yield f, img
