"""Interactive viewer (viser-gated).

Counterpart of gslam_tpu/viz/viewer.py: per-client render threads with
pause/resume and a render-target selector (rgb | n_touched | depth), and the
train/view time-sharing throttle. `serve_viewer` raises a clear error unless
viser imports (or a caller passes a server object with its GUI surface);
the offline orbit render of view_torch.py always works. Renders run on the
map's device.
"""

from __future__ import annotations

import numpy as np
import torch


class ViewerState:
    def __init__(self):
        self.paused = False
        self.target_type = "rgb"  # rgb | n_touched | depth


class TrainUtilThrottle:
    """Training/viewing time-sharing policy.

    The viewer throttles viewer refreshes so that training keeps
    `train_util` of the wall clock: with measured train/view throughputs
    (rays/s) it refreshes every
        update_every = train_util * view_time / (train_time * (1 - train_util))
    steps, and stalls training entirely for `move_grace` seconds after the
    user moves the camera. This class is the pure state machine — viser-free
    and unit-testable; `serve_viewer` drives it when a training loop is
    attached.
    """

    def __init__(self, train_util: float = 0.9, max_img_res: int = 2048,
                 move_grace: float = 0.1, warmup_steps: int = 5):
        self.train_util = float(train_util)
        self.max_img_res = int(max_img_res)
        self.move_grace = float(move_grace)
        self.warmup_steps = int(warmup_steps)
        self.last_move_time = -1e30
        self.last_update_step = 0
        self.num_train_rays_per_sec: float | None = None
        self.num_view_rays_per_sec: float = 100_000.0

    def note_move(self, now: float) -> None:
        self.last_move_time = now

    def train_stalled(self, now: float) -> bool:
        """Training yields while the user is actively moving the camera."""
        return (now - self.last_move_time) < self.move_grace

    def update_every(self, num_train_rays_per_step: int) -> float:
        """Steps between viewer refreshes at the configured train_util."""
        if self.num_train_rays_per_sec is None:
            raise ValueError(
                "num_train_rays_per_sec must be measured before throttling")
        util = min(self.train_util, 1.0 - 1e-6)
        train_time = num_train_rays_per_step / self.num_train_rays_per_sec
        view_time = self.max_img_res ** 2 / self.num_view_rays_per_sec
        return util * view_time / (train_time * (1.0 - util))

    def should_refresh(self, step: int, num_train_rays_per_step: int) -> bool:
        """Called once per training step; True when a viewer refresh is due
        (and records it). Refreshes are suppressed during warm-up while the
        throughput estimates settle, and train_util=1 disables them."""
        if step < self.warmup_steps or self.train_util >= 1.0:
            return False
        if step > self.last_update_step + self.update_every(
                num_train_rays_per_step):
            self.last_update_step = step
            return True
        return False


def render_viewer_target(gmap, target_type: str, w2c, K, width, height, cfg):
    """Render one viewer frame for a given target ('rgb' | 'depth' |
    'n_touched') as a uint8 image: the compute half of the serve loop,
    shared by the live server and the stub-driven tests."""
    from gslam_tpu_torch import to_device
    from gslam_tpu_torch.mapping.backend_ops import render_view_stats
    from gslam_tpu_torch.ops.rasterize import render_impl
    from gslam_tpu_torch.viz.visualization import false_colormap

    dev = gmap.means.device
    w2c, K = to_device(w2c, dev), to_device(K, dev)
    with torch.no_grad():
        vs = render_view_stats(gmap, w2c, K, width, height, cfg)
        if target_type == "rgb":
            return np.uint8(np.clip(vs.rgb.cpu().numpy(), 0, 1) * 255)
        if target_type == "depth":
            return false_colormap(vs.depth.cpu().numpy())
        # Per-pixel n_touched: re-render with each splat's color set to its
        # normalized touch count, so the blended image shows which regions
        # are dominated by widely visible splats.
        nt = vs.n_touched.to(torch.float32)
        norm = torch.clamp(nt / torch.clamp(nt.max(), min=1.0), 1e-4, 1 - 1e-4)
        fake_colors = torch.log(norm / (1.0 - norm))  # logit
        out = render_impl(
            **{**gmap.render_kwargs(), "logit_colors": fake_colors[:, None].repeat(1, 3)},
            viewmats=w2c[None], Ks=K[None], width=width, height=height,
            cfg=cfg.render)
        return false_colormap(out.rgb[0, :, :, 0].cpu().numpy())


def camera_to_w2c_K(wxyz, position, fov, width, height):
    """viser CameraState (wxyz quaternion, position, vertical fov) ->
    (world-to-camera [4,4], K [3,3]), numpy."""
    from gslam_tpu_torch.core.transforms import quaternion_to_matrix

    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = quaternion_to_matrix(
        torch.as_tensor(np.asarray(wxyz, np.float32))).numpy()
    c2w[:3, 3] = np.asarray(position, np.float32)
    w2c = np.linalg.inv(c2w)
    fy = height / (2.0 * np.tan(fov / 2.0))
    K = np.array(
        [[fy, 0, width / 2], [0, fy, height / 2], [0, 0, 1]], np.float32
    )
    return w2c, K


def serve_viewer(gmap, width=640, height=480, port=8080, map_config=None,
                 server=None, block=True):
    """Serve the interactive viewer over a map on any device. `server`
    defaults to a real viser.ViserServer; tests inject a stub object with the same GUI
    surface (gui.add_folder/button/dropdown/slider, on_client_connect,
    client.camera, client.scene.set_background_image) so the full serve
    path executes without the SDK. `block=False` returns the wired
    ViewerState instead of parking the main thread."""
    from gslam_tpu_torch.mapping.backend_ops import MapConfig

    if server is None:
        try:
            import viser
        except ImportError as e:
            raise RuntimeError(
                "viser is not installed in this environment; use "
                "`python view_torch.py <ckpt> --out dir` for offline orbit renders"
            ) from e

        server = viser.ViserServer(port=port, verbose=False)

    cfg = map_config or MapConfig()
    state = ViewerState()
    state.throttle = TrainUtilThrottle()
    state.stop = False

    with server.gui.add_folder("gslam_tpu_torch"):
        pause_btn = server.gui.add_button("pause/resume")
        target = server.gui.add_dropdown(
            "target", options=("rgb", "n_touched", "depth"), initial_value="rgb"
        )
        util = server.gui.add_slider(
            "train util", min=0.0, max=1.0, step=0.05, initial_value=0.9
        )

    @pause_btn.on_click
    def _(_):
        state.paused = not state.paused

    @target.on_update
    def _(_):
        state.target_type = target.value

    @util.on_update
    def _(_):
        state.throttle.train_util = util.value

    @server.on_client_connect
    def _(client):
        import threading
        import time

        @client.camera.on_update
        def _(_cam):
            state.throttle.note_move(time.time())

        def loop():
            while not state.stop:
                if state.paused:
                    time.sleep(0.1)
                    continue
                cam = client.camera
                w2c, K = camera_to_w2c_K(
                    cam.wxyz, cam.position, cam.fov, width, height)
                img = render_viewer_target(
                    gmap, state.target_type, w2c, K, width, height, cfg)
                client.scene.set_background_image(img, format="jpeg")
                time.sleep(0.05)

        threading.Thread(target=loop, daemon=True).start()

    if not block:
        return state
    print(f"viser viewer on port {port}; ctrl-c to stop")
    import time

    while not state.stop:
        time.sleep(1.0)
    return state
