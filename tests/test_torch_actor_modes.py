"""Behaviours of the port's actor runtime on the CPU, one test for each of
tests/test_slam_e2e.py's and tests/test_slam_modes.py's that runs a
SlamSystem beyond the module run of tests/test_torch_actor.py: threaded
mode, the NaN-frame fallback, the unhealthy abort, the plausibility guard,
RGB-D, PGO, the warp tracker, and the sensor stream's back-pressure.

The bounds are the JAX tests'. The runs are cut to fit the CPU test clock:
64x48 frames, 20 bootstrap and 3 per-frame mapping iterations over a window
of 2, 64 splats per tile, 4,096 slots (the JAX tests: 80x60 or 64x48, 40-50
and 5-6 iterations over a window of 5, 128 per tile, 8,192 slots). Once two
keyframes exist every frame runs a pose refinement of up to 25 evaluations
of the whole window, which costs most of a CPU run. The NaN-frame and
guard tests share one run (NaN at frame 3, the jump at frame 6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gslam_tpu_torch.io.synthetic import SyntheticDataset  # noqa: E402
from gslam_tpu_torch.mapping.backend_ops import MapConfig  # noqa: E402
from gslam_tpu_torch.ops.rasterize import RenderConfig  # noqa: E402
from gslam_tpu_torch.runtime.system import SlamConfig, SlamSystem  # noqa: E402
from gslam_tpu_torch.tracking.track import TrackingConfig  # noqa: E402

CPU = "cpu"
RCFG = RenderConfig(tile_capacity=64)
W, H = 64, 48


def small_cfg(track=None, **m_extra):
    return dict(
        tracking=TrackingConfig(warmup_steps=5, lbfgs_max_iter=10, lbfgs_max_eval=12,
                                render=RCFG, **(track or {})),
        mapping=MapConfig(num_iters_init=20, num_iters_mapping=3, window_size=2,
                          recent_window=2, render=RCFG, **m_extra),
        capacity=4096,
        kf_capacity=8,
    )


def walk(seq_len, seed, motion_scale, n_splats=400):
    return SyntheticDataset(seq_len=seq_len, width=W, height=H, n_splats=n_splats, seed=seed,
                            motion_scale=motion_scale, device=CPU)


def run(cfg, ds):
    system = SlamSystem(cfg, W, H, device=CPU)
    return system, system.run(ds)


# ------------------------------------------------------ test_slam_e2e.py's


def test_threaded_mode_runs(tmp_path):
    """The queue/thread pipeline produces a sane run too (not bit-identical
    to synchronous, but complete and finite)."""
    system, m = run(SlamConfig(**small_cfg(), run_dir=str(tmp_path / "thr"),
                               synchronous=False), walk(6, seed=2, motion_scale=0.01))
    assert m["L"] == 6
    assert np.isfinite(m.get("ate", np.inf))
    assert np.isfinite(np.stack([f.est_pose for f in system.frontend.frames])).all()


@pytest.fixture(scope="module")
def nan_and_jump_run(tmp_path_factory):
    """A NaN sensor frame at frame 3 and, at frame 6, a tracker result moved
    0.5 m (~25x the per-frame step: a flagrant basin jump)."""
    import gslam_tpu_torch.runtime.frontend as fe

    ds = walk(8, seed=4, motion_scale=0.02)
    ds.images = ds.images.copy()
    ds.images[3] = np.nan
    real_track = fe.track_frame
    jumped = []

    def jumpy_track(gmap, prior, exposure, img, K, w, h, cfg, gt_depth=None, device=None):
        res = real_track(gmap, prior, exposure, img, K, w, h, cfg, gt_depth=gt_depth,
                         device=device)
        jumpy_track.i += 1
        if jumpy_track.i == 6:
            bad = res.pose.clone()
            bad[:3, 3] += 0.5
            jumped.append(bad)
            res = res._replace(pose=bad)
        return res

    jumpy_track.i = 0  # frame 0 is pinned, track() starts at frame 1
    mp = pytest.MonkeyPatch()
    mp.setattr(fe, "track_frame", jumpy_track)
    run_dir = tmp_path_factory.mktemp("guard")
    try:
        system, m = run(SlamConfig(**small_cfg(), run_dir=str(run_dir), eval_stride=4), ds)
    finally:
        mp.undo()
    assert jumped
    return system, m, run_dir


def test_actor_nan_frame_survives_with_fallback(nan_and_jump_run):
    """The NaN frame is guard-rejected and counted in `health` while every
    pose stays finite; a recovered rejection is not a diverged run."""
    system, m, _ = nan_and_jump_run
    assert system.frontend.frames[3].rejected
    assert m["health"] >= 1
    assert m["diverged"] is False
    assert m["nonfinite_poses"] == 0
    assert np.isfinite(m["ate"])
    assert m["mean_track_evals"] > 0


def test_actor_host_abort_on_unhealthy(tmp_path):
    """SlamSystem aborts once the health counter crosses abort_unhealthy."""
    ds = walk(8, seed=4, motion_scale=0.01)
    ds.images = ds.images.copy()
    ds.images[2:6] = np.nan
    system = SlamSystem(SlamConfig(**small_cfg(), run_dir=str(tmp_path / "abort"),
                                   abort_unhealthy=2), W, H, device=CPU)
    with pytest.raises(RuntimeError, match="health counter"):
        system.run(ds)
    assert system.frontend.health == 2 and len(system.frontend.frames) == 4


def test_actor_plausibility_guard_rejects_basin_jump(nan_and_jump_run):
    """The jump falls back to the motion prior, counts in health and does not
    become a keyframe; trajectory.npy holds the [N, 4, 4] poses, which stay
    in the scene."""
    system, m, run_dir = nan_and_jump_run
    assert system.frontend.frames[6].rejected
    assert m["health"] >= 2, m
    assert 6 not in system.backend.frame_slot
    assert m["diverged"] is False
    assert m["nonfinite_poses"] == 0
    traj = np.load(run_dir / "trajectory.npy")
    assert traj.shape == (8, 4, 4)
    centers = np.stack([-p[:3, :3].T @ p[:3, 3] for p in traj])
    assert np.linalg.norm(np.diff(centers, axis=0), axis=1).max() < 0.2


# ----------------------------------------------------- test_slam_modes.py's


def test_rgbd_mode(tmp_path):
    cfg = small_cfg(track=dict(use_gt_depths=True), use_gt_depths=True)
    _, m = run(SlamConfig(**cfg, run_dir=str(tmp_path), eval_stride=4),
               walk(8, seed=3, motion_scale=0.015))
    assert m["L"] == 8
    assert m["ate"] < 0.08, m
    assert m["psnr"] > 14.0, m


def test_pgo_mode(tmp_path):
    system, m = run(SlamConfig(**small_cfg(enable_pgo=True, kf_m=0.03), run_dir=str(tmp_path),
                               eval_stride=4), walk(6, seed=4, motion_scale=0.02))
    assert m["L"] == 6
    # the pose graph has a node for every keyframe and at least the chain edges
    pg = system.backend.pose_graph
    kf_ids = sorted(system.backend.frame_slot.keys())
    assert all(k in pg for k in kf_ids)
    assert len(kf_ids) >= 2 and any(pg[k] for k in kf_ids)
    assert m["mean_refine_evals"] > 0


def test_warp_tracking_method(tmp_path, monkeypatch):
    """method="warp" is selectable end to end: frame 0 is pinned, and every
    later frame tracks by dense warp alignment against the synced keyframe
    render instead of through the splat render."""
    import gslam_tpu_torch.runtime.frontend as fe

    warps = []
    real = fe.warp_track
    monkeypatch.setattr(fe, "warp_track", lambda *a, **kw: warps.append(1) or real(*a, **kw))
    cfg = small_cfg(track=dict(method="warp"))
    _, m = run(SlamConfig(**cfg, run_dir=str(tmp_path), eval_stride=3, sync_every=2),
               walk(6, seed=5, motion_scale=0.01))
    assert m["L"] == 6
    assert np.isfinite(m["ate"])
    assert m["ate"] < 0.15, m
    assert len(warps) == 5


def test_sensor_stream_backpressure():
    from gslam_tpu_torch.io.stream import SensorStream

    ds = SyntheticDataset(seq_len=12, width=48, height=32, n_splats=100, seed=0, device=CPU)
    stream = SensorStream(ds, maxsize=3).start()
    got = []
    while True:
        f = stream.get(timeout=30)
        if f is None:
            break
        got.append(f.index)
    assert got == list(range(12))
    stream.thread.join(timeout=30)
    assert not stream.thread.is_alive()
