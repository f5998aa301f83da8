"""The port's command line and offline tools on the CPU: main_torch's
`--set` overrides (tests/test_cli.py's cases on the port's configs), both
runtimes end to end through `main_torch.main` with their artifacts and a
resume, the B-spline (tests/test_components.py's cases, and parity with the
JAX package's interpolation on the same control points), pipeline_torch,
view_torch and the viewer (throttle and a stub viser server).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import main_torch  # noqa: E402
import pipeline_torch  # noqa: E402
import view_torch  # noqa: E402
from gslam_tpu.eval import spline as jspline  # noqa: E402
from gslam_tpu_torch.core.transforms import so3_exp  # noqa: E402
from gslam_tpu_torch.eval.spline import (  # noqa: E402
    Spline, fit_spline, init_spline, seed_from_poses, spline_acceleration, spline_pose,
    spline_velocity,
)
from gslam_tpu_torch.mapping.backend_ops import MapConfig  # noqa: E402
from gslam_tpu_torch.runtime.system import SlamConfig  # noqa: E402
from gslam_tpu_torch.tracking.track import TrackingConfig  # noqa: E402

CPU = "cpu"


# ------------------------------------------------------- tests/test_cli.py


def _cfg():
    return SlamConfig(tracking=TrackingConfig(), mapping=MapConfig(), capacity=1024,
                      kf_capacity=8, synchronous=True, run_dir="runs/test_cli")


def test_set_frozen_nested_field():
    cfg = main_torch.apply_overrides(_cfg(), ["mapping.ssim_weight=0.1"])
    assert cfg.mapping.ssim_weight == 0.1


def test_set_doubly_nested_frozen_field():
    cfg = main_torch.apply_overrides(_cfg(), ["mapping.render.tile_capacity=64",
                                              "tracking.render.tile_chunk=8"])
    assert cfg.mapping.render.tile_capacity == 64
    assert cfg.tracking.render.tile_chunk == 8


def test_set_top_level_and_bool():
    cfg = main_torch.apply_overrides(
        _cfg(), ["capacity=2048", "mapping.enable_pgo=true", "tracking.use_gt_depths=false",
                 "tracking.method=gn", "tracking.gn_iters=8"])
    assert cfg.capacity == 2048
    assert cfg.mapping.enable_pgo is True
    assert cfg.tracking.use_gt_depths is False
    assert cfg.tracking.method == "gn" and cfg.tracking.gn_iters == 8


@pytest.mark.parametrize("path", ["mapping.not_a_field=1", "tracking.render.backend=xla",
                                  "tracking.nope.tile_size=8"])
def test_set_unknown_field_errors(path):
    """The port's RenderConfig has no backend switch: CUDA tensors take the
    kernels, and only Gauss-Newton tracking takes the forward-mode route."""
    with pytest.raises(SystemExit):
        main_torch.apply_overrides(_cfg(), [path])


def test_set_preserves_other_fields():
    cfg = main_torch.apply_overrides(_cfg(), ["mapping.pose_lr=0.01"])
    assert cfg.mapping.pose_lr == 0.01
    assert cfg.mapping.window_size == MapConfig().window_size
    assert cfg.tracking == TrackingConfig()


def test_parser_defaults_match_main_py():
    """main_torch's flags and defaults are main.py's, plus --device (default
    None: CUDA) and --init-ipd 0 on every device."""
    import main

    ours = {a.dest: a.default for a in main_torch.build_parser()._actions}
    theirs = {a.dest: a.default for a in main.build_parser()._actions}
    assert ours.pop("device") is None
    assert ours.pop("init_ipd") == 0 and theirs.pop("init_ipd") is None
    assert ours == theirs


# ------------------------------------------------------- main_torch.main


SMALL = ["--device", "cpu", "--dataset", "raytrace", "--width", "64", "--height", "48",
         "--motion-scale", "0.02", "--seed", "1", "--use-gt-depths", "--capacity", "2048",
         "--kf-capacity", "8", "--init-iters", "20", "--mapping-iters", "3",
         "--eval-stride", "2", "--set", "tracking.method=gn",
         "--set", "tracking.pyramid_levels=2", "--set", "tracking.gn_iters=4",
         "--set", "mapping.window_size=3", "--set", "mapping.recent_window=3"]


def _artifacts(run_dir, n):
    m = json.loads((run_dir / "metrics.json").read_text())
    traj = np.load(run_dir / "trajectory.npy")
    assert traj.shape == (n, 4, 4) and np.isfinite(traj).all()
    assert m["L"] == n and m["nonfinite_poses"] == 0 and not m["diverged"]
    assert np.isfinite(m["ate"]) and np.isfinite(m["psnr"])
    return m


def test_main_actor_runs_writes_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    m = main_torch.main(SMALL + ["--seq-len", "4", "--run-name", "actor",
                                 "--set", "checkpoint_every=2"])
    run = tmp_path / "runs/actor"
    _artifacts(run, 4)
    assert m["C"] >= 1
    for name in ("splats.npz", "traj.png", "checkpoint.npz", "args.txt"):
        assert (run / name).is_file(), name
    assert "--device cpu" in (run / "args.txt").read_text()
    # the checkpoint was taken after frame 2: a resume tracks frame 3 again
    m2 = main_torch.main(SMALL + ["--seq-len", "4", "--run-name", "resumed",
                                  "--resume", str(run / "checkpoint.npz")])
    _artifacts(tmp_path / "runs/resumed", 4)
    assert m2["C"] >= 1


def test_main_fused_runs_writes_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    fused = ["--fused", "--chunk", "1", "--sync-every", "2", "--init-n-new", "400",
             "--kf-n-new", "50"]
    # a fused checkpoint resumes into the same trajectory buffers (max_frames)
    m = main_torch.main(SMALL + fused + ["--seq-len", "4", "--max-frames", "5",
                                         "--run-name", "fused", "--checkpoint-every", "2"])
    run = tmp_path / "runs/fused"
    _artifacts(run, 4)
    tel = np.load(run / "telemetry.npz")
    assert tel["n_evals"].shape == (4,) and (tel["n_evals"][1:] > 0).all()
    assert m["total_map_iters"] > 0 and (run / "fused_ckpt.npz").is_file()
    m2 = main_torch.main(SMALL + fused + ["--seq-len", "5", "--max-frames", "5",
                                          "--run-name", "fused_resumed",
                                          "--resume", str(run / "fused_ckpt.npz")])
    _artifacts(tmp_path / "runs/fused_resumed", 5)
    assert m2["C"] >= 1


# ------------------------------------------------ tests/test_components.py


def test_spline_interpolates_line():
    sp = init_spline(32, interval=0.5, start_time=0.0, device=CPU)
    times = torch.arange(20, dtype=torch.float32) * 0.5
    pos = torch.stack([times, 2 * times, torch.zeros_like(times)], -1)
    rot = torch.eye(3).repeat(20, 1, 1)
    sp = seed_from_poses(sp, times, rot, pos)
    q_t = torch.tensor([3.0, 5.25, 7.4])
    R, p = spline_pose(sp, q_t)
    # straight line: spline reproduces it exactly in the interior
    np.testing.assert_allclose(p[:, 0].numpy(), q_t.numpy(), atol=1e-3)
    np.testing.assert_allclose(p[:, 1].numpy(), 2 * q_t.numpy(), atol=2e-3)
    v = spline_velocity(sp, q_t)
    np.testing.assert_allclose(v.numpy(), np.tile([1.0, 2.0, 0.0], (3, 1)), atol=1e-3)
    a = spline_acceleration(sp, q_t)
    np.testing.assert_allclose(a.numpy(), 0.0, atol=1e-2)


def test_spline_rotation_continuity():
    sp = init_spline(16, interval=1.0, start_time=0.0, device=CPU)
    times = torch.arange(10, dtype=torch.float32)
    w = torch.stack([0.1 * times, torch.zeros_like(times), torch.zeros_like(times)], -1)
    sp = seed_from_poses(sp, times, so3_exp(w), torch.zeros((10, 3)))
    R, _ = spline_pose(sp, torch.tensor([4.0, 4.5, 5.0]))
    for i in range(3):
        np.testing.assert_allclose(R[i].numpy() @ R[i].numpy().T, np.eye(3), atol=1e-5)


def test_fit_spline_to_noisy_poses(rng):
    sp = init_spline(24, interval=0.5, start_time=0.0, device=CPU)
    times = torch.from_numpy(np.linspace(0, 8, 40, dtype=np.float32))
    pos_gt = torch.stack([torch.sin(times), torch.cos(times), 0.2 * times], -1)
    rot_gt = torch.eye(3).repeat(40, 1, 1)
    sp = seed_from_poses(sp, times, rot_gt, pos_gt)
    noisy = pos_gt + torch.from_numpy(rng.normal(scale=0.05, size=(40, 3)).astype(np.float32))
    sp2, losses = fit_spline(sp, times, rot_gt, noisy, n_steps=100)
    assert losses.shape == (100,) and float(losses[-1]) < float(losses[0])
    _, p = spline_pose(sp2, times[5:-5])
    err = torch.linalg.norm(p - pos_gt[5:-5], dim=-1)
    assert float(err.mean()) < 0.1


def test_spline_matches_jax():
    """Interpolated pose, velocity and acceleration of the same control
    points (random rotations and positions, 12 active of 16) in both
    packages, at times across every segment and beyond both ends."""
    rng = np.random.default_rng(11)
    n, active = 16, 12
    rot = np.asarray(so3_exp(torch.from_numpy(rng.normal(scale=0.4, size=(n, 3))
                                              .astype(np.float32))))
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    times = np.sort(rng.uniform(-0.3, 0.25 * active + 0.3, 64)).astype(np.float32)
    ours = Spline(torch.from_numpy(rot), torch.from_numpy(pos), 0.25, 0.1,
                  torch.tensor(active, dtype=torch.int32))
    theirs = jspline.Spline(jnp.asarray(rot), jnp.asarray(pos), 0.25, 0.1,
                            jnp.asarray(active, jnp.int32))
    t, jt = torch.from_numpy(times), jnp.asarray(times)
    R, p = spline_pose(ours, t)
    jR, jp = jspline.spline_pose(theirs, jt)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(spline_velocity(ours, t).numpy(),
                               np.asarray(jspline.spline_velocity(theirs, jt)), atol=1e-4)
    np.testing.assert_allclose(spline_acceleration(ours, t).numpy(),
                               np.asarray(jspline.spline_acceleration(theirs, jt)),
                               atol=1e-3)
    # seeding from the same samples picks the same control points
    sp = seed_from_poses(init_spline(n, 0.25, 0.1, device=CPU), t[:40],
                         torch.from_numpy(rot).repeat(3, 1, 1)[:40],
                         torch.from_numpy(pos).repeat(3, 1)[:40])
    jsp = jspline.seed_from_poses(jspline.init_spline(n, 0.25, 0.1), jt[:40],
                                  jnp.tile(jnp.asarray(rot), (3, 1, 1))[:40],
                                  jnp.tile(jnp.asarray(pos), (3, 1))[:40])
    assert int(sp.n_active) == int(jsp.n_active)
    np.testing.assert_array_equal(sp.pos_cps.numpy(), np.asarray(jsp.pos_cps))


# ----------------------------------------------------- pipeline, view, viewer


def test_pipeline_and_view_tools(tmp_path):
    out = tmp_path / "fit"
    common = ["--device", CPU, "--synthetic", "--n-splats", "300", "--width", "48",
              "--height", "32", "--out", str(out)]
    l1_start = pipeline_torch.main(common + ["--iters", "0"])
    l1 = pipeline_torch.main(common + ["--iters", "30"])
    assert l1 < 0.7 * l1_start, (l1_start, l1)
    for name in ("target.png", "fit.png", "splats.npz"):
        assert (out / name).is_file()
    orbit = tmp_path / "orbit"
    view_torch.main([str(out / "splats.npz"), "--device", CPU, "--out", str(orbit),
                     "--n-views", "2", "--width", "48", "--height", "32"])
    from PIL import Image

    imgs = [np.asarray(Image.open(orbit / f"{i:04}.png")) for i in range(2)]
    assert all(im.shape == (32, 48, 3) for im in imgs)
    assert all(im.max() > 0 for im in imgs)  # the orbit sees the fitted splats


def test_train_util_throttle():
    from gslam_tpu_torch.viz.viewer import TrainUtilThrottle

    th = TrainUtilThrottle(train_util=0.9, max_img_res=2048, warmup_steps=5)
    th.num_train_rays_per_sec = 1e6
    th.num_view_rays_per_sec = 1e5
    n = 4096
    expect = 0.9 * (2048**2 / 1e5) / ((n / 1e6) * 0.1)
    assert abs(th.update_every(n) - expect) / expect < 1e-9
    assert not th.should_refresh(3, n)
    th2 = TrainUtilThrottle(train_util=0.5, max_img_res=64, warmup_steps=0)
    th2.num_train_rays_per_sec = 1e6
    th2.num_view_rays_per_sec = 1e6
    every = th2.update_every(n)
    assert abs(every - 1.0) < 1e-9
    assert th2.should_refresh(2, n)
    assert not th2.should_refresh(3, n)
    assert th2.should_refresh(4, n)
    th3 = TrainUtilThrottle(train_util=1.0, warmup_steps=0)
    th3.num_train_rays_per_sec = 1e6
    assert not th3.should_refresh(100, n)
    th.note_move(1000.0)
    assert th.train_stalled(1000.05)
    assert not th.train_stalled(1000.2)


def test_serve_viewer_with_stub_server(rng):
    """The whole serve path with a stub viser server: GUI wiring, the
    client's render thread, the three render targets and the callbacks."""
    import contextlib
    import time

    from scene_utils import make_scene

    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.viz.viewer import (
        camera_to_w2c_K, render_viewer_target, serve_viewer,
    )

    params, _, _, _, _ = make_scene(rng, n=200)
    gmap = gaussian_map_from_numpy({k: np.asarray(v) for k, v in params.items()},
                                   device=CPU)
    cfg = MapConfig(render=RenderConfig(tile_capacity=64, pairs_per_gaussian=8))

    class Handle:
        def __init__(self, value=None):
            self.value = value
            self._cbs = []

        def on_click(self, fn):
            self._cbs.append(fn)
            return fn

        on_update = on_click

        def fire(self):
            for fn in self._cbs:
                fn(self)

    class Gui:
        def __init__(self):
            self.handles = {}

        def add_folder(self, name):
            return contextlib.nullcontext()

        def _add(self, name, value=None):
            self.handles[name] = Handle(value)
            return self.handles[name]

        def add_button(self, name):
            return self._add(name)

        def add_dropdown(self, name, options, initial_value):
            return self._add(name, initial_value)

        def add_slider(self, name, min, max, step, initial_value):
            return self._add(name, initial_value)

    class StubServer:
        def __init__(self):
            self.gui = Gui()
            self.connect_cb = None

        def on_client_connect(self, fn):
            self.connect_cb = fn
            return fn

    class Scene:
        def __init__(self):
            self.images = []

        def set_background_image(self, img, format=None):
            self.images.append(np.asarray(img))

    class Camera:
        wxyz = np.array([1.0, 0, 0, 0], np.float32)
        position = np.array([0.0, 0.0, -2.0], np.float32)
        fov = 1.0

        def on_update(self, fn):
            return fn

    class Client:
        camera = Camera()

        def __init__(self):
            self.scene = Scene()

    server = StubServer()
    state = serve_viewer(gmap, width=64, height=48, map_config=cfg, server=server,
                         block=False)
    assert server.connect_cb is not None
    server.gui.handles["pause/resume"].fire()
    assert state.paused
    server.gui.handles["pause/resume"].fire()
    assert not state.paused
    server.gui.handles["target"].value = "depth"
    server.gui.handles["target"].fire()
    assert state.target_type == "depth"
    server.gui.handles["train util"].value = 0.5
    server.gui.handles["train util"].fire()
    assert state.throttle.train_util == 0.5

    client = Client()
    server.connect_cb(client)
    deadline = time.time() + 60.0
    while not client.scene.images and time.time() < deadline:
        time.sleep(0.05)
    state.stop = True
    assert client.scene.images, "serve loop produced no frames"
    img = client.scene.images[0]
    assert img.shape == (48, 64, 3) and img.dtype == np.uint8

    w2c, K = camera_to_w2c_K(Camera.wxyz, Camera.position, Camera.fov, 64, 48)
    for target in ("rgb", "depth", "n_touched"):
        im = render_viewer_target(gmap, target, w2c, K, 64, 48, cfg)
        assert im.shape == (48, 64, 3) and im.dtype == np.uint8


def test_serve_viewer_needs_viser_without_a_server(monkeypatch):
    import sys

    from gslam_tpu_torch.mapping.gaussians import empty_map
    from gslam_tpu_torch.viz.viewer import serve_viewer

    monkeypatch.setitem(sys.modules, "viser", None)  # `import viser` fails
    with pytest.raises(RuntimeError, match="viser"):
        serve_viewer(empty_map(4, device=CPU))
