"""The port's actor runtime (runtime/{frontend,backend,system}.py) on the CPU:
tests/test_slam_e2e.py's run in the port alone, at that test's scene and
configuration. One module-scoped SlamSystem run serves the quality bounds,
the artifacts, the map checkpoint, a resume from its checkpoint and the
sync snapshot's isolation. The other behaviours of test_slam_e2e.py and
test_slam_modes.py are in tests/test_torch_actor_modes.py; the actor's
parity with the JAX package, call by call, is in tests/test_torch_lbfgs.py.
"""

import json

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


# ------------------------------------------------- tests/test_slam_e2e.py's run

RCFG = RenderConfig(tile_capacity=128, pairs_per_gaussian=8)

SMALL = dict(
    tracking=TrackingConfig(warmup_steps=5, lbfgs_max_iter=10, lbfgs_max_eval=12,
                            render=RCFG),
    mapping=MapConfig(num_iters_init=50, num_iters_mapping=6, window_size=5,
                      recent_window=4, render=RCFG),
    capacity=8192,
    kf_capacity=16,
)


def e2e_data(seq_len=10):
    """tests/test_slam_e2e.py's scene; a longer sequence starts with the same
    frames."""
    return SyntheticDataset(seq_len=seq_len, width=80, height=60, n_splats=600, seed=1,
                            motion_scale=0.015, device=CPU)


@pytest.fixture(scope="module")
def slam_run(tmp_path_factory):
    ds = e2e_data()
    run_dir = tmp_path_factory.mktemp("run")
    system = SlamSystem(SlamConfig(**SMALL, run_dir=str(run_dir), eval_stride=3), 80, 60,
                        device=CPU)
    metrics = system.run(ds)
    return ds, system, metrics, run_dir


def test_slam_completes(slam_run):
    _, system, metrics, _ = slam_run
    assert metrics["L"] == 10
    assert metrics["C"] >= 1
    assert metrics["N"] > 1000  # init inserts 5000 minus pruning
    assert metrics["health"] == 0 and not metrics["diverged"]


def test_slam_phases_come_from_the_backend_spans(slam_run):
    """phase_ms, phase_total_s and phase_calls keep their keys: the backend's
    phases, read from the recorder's backend.<phase> spans of this run."""
    _, _, metrics, _ = slam_run
    calls = metrics["phase_calls"]
    assert {"map", "insert", "sync"} <= set(calls) <= {"map", "insert", "prune",
                                                       "pose_refine", "sync"}
    assert set(metrics["phase_ms"]) == set(metrics["phase_total_s"]) == set(calls)
    for k, n in calls.items():
        total = metrics["phase_total_s"][k]
        assert n > 0 and metrics["phase_ms"][k] > 0
        assert abs(metrics["phase_ms"][k] * n / 1e3 - total) <= 0.0051 + 0.0051 * n / 1e3


def test_slam_trajectory_quality(slam_run):
    _, _, metrics, _ = slam_run
    assert metrics["ate"] < 0.05, metrics


def test_slam_reconstruction_quality(slam_run):
    _, _, metrics, _ = slam_run
    assert metrics["psnr"] > 23.0, metrics
    assert metrics["ssim"] > 0.89, metrics


def test_slam_artifacts_written(slam_run):
    _, system, metrics, run_dir = slam_run
    for name in ("splats.npz", "metrics.json", "traj.png"):
        assert (run_dir / name).exists(), name
    # the estimated world-to-camera poses, [N, 4, 4] as the fused runtime's
    traj = np.load(run_dir / "trajectory.npy")
    assert traj.shape == (10, 4, 4)
    np.testing.assert_array_equal(traj, np.stack([f.est_pose for f in system.frontend.frames]))
    saved = json.loads((run_dir / "metrics.json").read_text())
    assert saved["L"] == 10 and saved["ate"] == pytest.approx(metrics["ate"])


def test_checkpoint_roundtrip(slam_run):
    from gslam_tpu_torch.mapping.backend_ops import render_view_stats
    from gslam_tpu_torch.runtime.checkpoint import load_map

    _, system, _, run_dir = slam_run
    gmap, _ = load_map(run_dir / "splats.npz", device=CPU)
    assert int(gmap.n_live()) == int(system.backend.gmap.n_live())
    # the loaded map renders identically
    pose = torch.from_numpy(system.frontend.frames[0].est_pose)
    a = render_view_stats(system.backend.gmap, pose, system.backend.K, 80, 60,
                          system.cfg.mapping)
    b = render_view_stats(gmap, pose, system.backend.K, 80, 60, system.cfg.mapping)
    np.testing.assert_array_equal(a.rgb.numpy(), b.rgb.numpy())


def test_checkpoint_resume(slam_run, tmp_path):
    """tests/test_slam_modes.py's resume, from the module run's end: the
    state round-trips through save_checkpoint / restore_system, and the
    resumed run finishes a longer sequence (without idle optimization,
    whose pose refinement would cost ~15 s a frame on one CPU core)."""
    from gslam_tpu_torch.runtime.checkpoint import restore_system, save_checkpoint

    _, sys_a, _, _ = slam_run
    save_checkpoint(tmp_path / "ckpt.npz", sys_a)
    cfg = SlamConfig(**SMALL, run_dir=str(tmp_path / "b"), eval_stride=4, idle_opt_per_frame=0)
    sys_b = SlamSystem(cfg, 80, 60, device=CPU)
    assert restore_system(tmp_path / "ckpt.npz", sys_b) == 10
    a, b = sys_a.backend, sys_b.backend
    for f in ("alive", "means", "logit_colors"):
        np.testing.assert_array_equal(getattr(b.gmap, f).numpy(), getattr(a.gmap, f).numpy())
    for name in ("mu", "nu"):
        for f, v in getattr(a.opt_state, name).items():
            np.testing.assert_array_equal(getattr(b.opt_state, name)[f].numpy(), v.numpy())
    np.testing.assert_array_equal(b.kf.poses().numpy(), a.kf.poses().numpy())
    np.testing.assert_array_equal(b.key.numpy(), a.key.numpy())
    assert b.kf_order == a.kf_order and b.pose_graph == a.pose_graph
    assert b.total_step == a.total_step and len(sys_b.frontend.frames) == 10
    metrics = sys_b.run(e2e_data(12))
    assert metrics["L"] == 12
    assert np.isfinite(metrics["ate"])


def test_sync_snapshot_is_isolated(slam_run):
    """The frontend's map snapshot does not change when the backend steps
    after apply_sync: it shares no memory with the backend's map."""
    _, system, _, _ = slam_run
    be, fe = system.backend, system.frontend
    fe.apply_sync(be.sync_payload())
    before = {f: v.clone() for f, v in fe.gmap._asdict().items()}
    be.pause_map_optim = False
    be.optimize_map(1)
    be.run_pruning()
    moved = [f for f in before if not torch.equal(getattr(be.gmap, f), before[f])]
    assert "means" in moved
    for f, v in before.items():
        assert torch.equal(getattr(fe.gmap, f), v), f
        assert getattr(fe.gmap, f).data_ptr() != getattr(be.gmap, f).data_ptr()
