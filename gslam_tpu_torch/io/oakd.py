"""OAK-D live stereo-depth camera sensor (depthai-gated).

Counterpart of gslam_tpu/io/oakd.py: color stream plus stereo depth aligned
to color, scaled intrinsics, frames delivered as they arrive. Construction
raises a clear error when the depthai SDK is missing, so the module (and
`--dataset oak` plumbing) stays importable without it.
"""

from __future__ import annotations

import numpy as np

import torch

from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.io.frames import Frame


class OakdSensor:
    def __init__(self, fps: float = 30.0, isp_scale: int = 3):
        try:
            import depthai as dai
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "depthai is not installed; OAK-D capture requires the "
                "depthai SDK and a connected camera"
            ) from e

        self.dai = dai
        self.fps = fps
        pipeline = dai.Pipeline()

        cam = pipeline.create(dai.node.ColorCamera)
        cam.setBoardSocket(dai.CameraBoardSocket.CAM_A)
        cam.setResolution(dai.ColorCameraProperties.SensorResolution.THE_1080_P)
        cam.setIspScale(1, isp_scale)
        cam.setFps(fps)

        left = pipeline.create(dai.node.MonoCamera)
        left.setBoardSocket(dai.CameraBoardSocket.CAM_B)
        right = pipeline.create(dai.node.MonoCamera)
        right.setBoardSocket(dai.CameraBoardSocket.CAM_C)
        stereo = pipeline.create(dai.node.StereoDepth)
        stereo.setDefaultProfilePreset(
            dai.node.StereoDepth.PresetMode.HIGH_DENSITY
        )
        stereo.setDepthAlign(dai.CameraBoardSocket.CAM_A)
        left.out.link(stereo.left)
        right.out.link(stereo.right)

        xout_rgb = pipeline.create(dai.node.XLinkOut)
        xout_rgb.setStreamName("rgb")
        cam.isp.link(xout_rgb.input)
        xout_d = pipeline.create(dai.node.XLinkOut)
        xout_d.setStreamName("depth")
        stereo.depth.link(xout_d.input)

        self.device = dai.Device(pipeline)
        self.q_rgb = self.device.getOutputQueue("rgb", maxSize=4, blocking=False)
        self.q_depth = self.device.getOutputQueue("depth", maxSize=4, blocking=False)

        calib = self.device.readCalibration()
        w, h = cam.getIspSize()
        K = np.asarray(
            calib.getCameraIntrinsics(dai.CameraBoardSocket.CAM_A, w, h),
            np.float32,
        )
        self.camera = Camera(K=torch.from_numpy(K), height=h, width=w)
        self._idx = 0

    def init(self):
        return

    def __iter__(self):
        while True:
            rgb_msg = self.q_rgb.get()
            depth_msg = self.q_depth.tryGet()
            rgb = np.float32(rgb_msg.getCvFrame()[..., ::-1]) / 255.0
            depth = None
            if depth_msg is not None:
                depth = np.float32(depth_msg.getFrame()) / 1000.0  # mm -> m
            yield Frame(
                image=rgb,
                timestamp=rgb_msg.getTimestamp().total_seconds(),
                camera=self.camera,
                index=self._idx,
                gt_depth=depth,
            )
            self._idx += 1

    def __len__(self):
        return 10**9
