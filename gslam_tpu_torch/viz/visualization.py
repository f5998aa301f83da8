"""Streaming telemetry sinks and image utilities.

Counterpart of the sink half of gslam_tpu/viz/visualization.py: per-frame
pose, pinhole, render/depth/uncertainty images and loss/fps scalars, plus
the splat point cloud. `NullSink` does nothing, `DiskSink` writes images
into a run directory, `RerunSink` streams to rerun-sdk and imports it when
it is built (it raises where the SDK is missing). Sinks take numpy
arrays; `log_splats` takes the map as tensors on any device.
"""

from __future__ import annotations

import numpy as np


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def false_colormap(
    image: np.ndarray,
    near: float | None = None,
    far: float | None = None,
    mask: np.ndarray | None = None,
    colormap: str = "turbo",
) -> np.ndarray:
    """[H, W] scalar image -> [H, W, 3] uint8 colormap."""
    from matplotlib import colormaps

    img = np.asarray(image, np.float32)
    sel = img if mask is None else img[mask]
    lo = float(sel.min()) if near is None else near
    hi = float(sel.max()) if far is None else far
    norm = np.clip(np.nan_to_num((img - lo) / (hi - lo + 1e-10)), 0.0, 1.0)
    lut = np.asarray(colormaps[colormap].colors)
    out = (lut[(norm * 255).astype(np.int32)] * 255).astype(np.uint8)
    if mask is not None:
        out[~mask] = 0
    return out


class TelemetrySink:
    """Interface: log_frame / log_splats / log_scalar. `wants_images` tells
    the frontend whether to spend a render producing per-frame images."""

    wants_images = False

    def log_frame(self, frame, rendered=None, depth=None, beta=None,
                  loss=None, tracking_time=None):
        pass

    def log_splats(self, gmap):
        pass

    def log_scalar(self, name: str, value: float, step: int | None = None):
        pass


class NullSink(TelemetrySink):
    pass


class DiskSink(TelemetrySink):
    """Dump renders/depth/uncertainty images per frame into a run directory."""

    wants_images = True

    def __init__(self, run_dir):
        from pathlib import Path

        self.dir = Path(run_dir)
        for sub in ("gt", "renders", "depths", "betas"):
            (self.dir / sub).mkdir(parents=True, exist_ok=True)

    def log_frame(self, frame, rendered=None, depth=None, beta=None,
                  loss=None, tracking_time=None):
        from PIL import Image

        i = frame.index
        if frame.image is not None:
            Image.fromarray(np.uint8(np.clip(frame.image, 0, 1) * 255)).save(
                self.dir / f"gt/{i:08}.jpg")
        if rendered is not None:
            Image.fromarray(np.uint8(np.clip(np.asarray(rendered), 0, 1) * 255)).save(
                self.dir / f"renders/{i:08}.jpg")
        if depth is not None:
            d = np.asarray(depth)
            Image.fromarray(false_colormap(d, near=0.2, far=min(2.5, float(d.max()) or 1.0))
                            ).save(self.dir / f"depths/{i:08}.jpg")
        if beta is not None:
            Image.fromarray(false_colormap(np.asarray(beta), near=0.0, far=2.0)).save(
                self.dir / f"betas/{i:08}.jpg")


class RerunSink(TelemetrySink):
    """rerun-sdk streaming telemetry (raises at construction without it)."""

    wants_images = True

    def __init__(self, run_name: str = "gslam_tpu"):
        import rerun as rr  # raises if unavailable

        self.rr = rr
        rr.init("gslam_tpu", recording_id=run_name, spawn=True)
        rr.log("/tracking", rr.ViewCoordinates.RIGHT_HAND_Y_DOWN, static=True)

    def log_frame(self, frame, rendered=None, depth=None, beta=None,
                  loss=None, tracking_time=None):
        rr = self.rr
        name = "/tracking/frame"
        if frame.est_pose is not None:
            c2w = np.linalg.inv(frame.est_pose)
            rr.log(name, rr.Transform3D(translation=c2w[:3, 3], mat3x3=c2w[:3, :3]))
            rr.log(f"{name}/cam", rr.Pinhole(
                image_from_camera=_np(frame.camera.K),
                width=frame.camera.width, height=frame.camera.height))
        if frame.image is not None:
            rr.log(f"{name}/cam/gt", rr.Image(
                np.uint8(np.clip(frame.image, 0, 1) * 255)).compress(jpeg_quality=85))
        if rendered is not None:
            rr.log(f"{name}/cam/render", rr.Image(
                np.uint8(np.clip(np.asarray(rendered), 0, 1) * 255)).compress(jpeg_quality=85))
        if depth is not None:
            rr.log(f"{name}/cam/depth", rr.DepthImage(np.asarray(depth)))
        if loss is not None:
            rr.log("/metrics/tracking_loss", rr.Scalar(float(loss)))
        if tracking_time is not None and tracking_time > 0:
            rr.log("/metrics/fps", rr.Scalar(1.0 / tracking_time))

    def log_splats(self, gmap):
        rr = self.rr
        alive = _np(gmap.alive)
        means = _np(gmap.means)[alive]
        colors = 1.0 / (1.0 + np.exp(-_np(gmap.logit_colors)[alive]))
        rr.log("/tracking/splats", rr.Points3D(means, colors=colors, radii=0.004))

    def log_scalar(self, name, value, step=None):
        self.rr.log(f"/metrics/{name}", self.rr.Scalar(float(value)))


def make_sink(kind: str = "auto", run_dir=None, run_name: str = "gslam_tpu"):
    """'auto' prefers rerun when importable, else disk dumps when a run dir
    is given, else a no-op sink."""
    if kind in ("rerun", "auto"):
        try:
            return RerunSink(run_name)
        except ImportError:
            if kind == "rerun":
                raise
    if kind in ("disk", "auto") and run_dir is not None:
        return DiskSink(run_dir)
    return NullSink()
