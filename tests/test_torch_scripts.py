"""The port's tools (scripts/*_torch.py, teleop_torch.py) against their JAX
twins on the CPU at cut sizes, and scripts/decode_run.py on run directories
that main_torch.py writes.

Inputs come from one numpy seed and go through both packages, or both
scripts run in this process and their outputs are compared line for line.
Tolerances are stated at each comparison.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
if str(SCRIPTS) not in sys.path:
    sys.path.insert(0, str(SCRIPTS))

import bench_1m_torch  # noqa: E402
import decode_run  # noqa: E402
import fit_spline_torch  # noqa: E402
import gslam_tpu  # noqa: E402
import gslam_tpu_torch  # noqa: E402
import main_torch  # noqa: E402
import make_npz_dataset_torch  # noqa: E402
import repro_f16_torch  # noqa: E402
import study_tracking_torch  # noqa: E402
import teleop  # noqa: E402
import teleop_torch  # noqa: E402


def _load_jax_script(name, directory=SCRIPTS):
    """<directory>/<name>.py (a JAX script; scripts/ by default) as a module.
    Those scripts put a fixed absolute path at the head of sys.path when
    imported, so sys.path is restored around the import: every later import
    in this process resolves from this checkout."""
    saved = list(sys.path)
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", directory / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = saved
    return module


_PATH_BEFORE = list(sys.path)
j_make_npz_script = _load_jax_script("make_npz_dataset")
j_study_script = _load_jax_script("study_tracking")
_PATH_AFTER = list(sys.path)

CPU = "cpu"


def test_modules_come_from_this_checkout():
    """Both packages, the scripts and the teleop twins load from this
    checkout, and loading the JAX scripts left sys.path as it was."""
    for module in (gslam_tpu, gslam_tpu_torch, teleop, teleop_torch, main_torch,
                   bench_1m_torch, study_tracking_torch, j_study_script, j_make_npz_script):
        assert Path(module.__file__).resolve().is_relative_to(ROOT), module.__file__
    assert _PATH_AFTER == _PATH_BEFORE


def _run_script(monkeypatch, capsys, module, argv):
    """A script whose main() reads sys.argv, run in this process; its stdout."""
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out


# ------------------------------------------------ scripts/bench_1m_torch.py


def test_bench_1m_point_matches_jax():
    """bench_1m.py's point at a cut size (4,096 slots, 3,000 live, 128x96,
    fx 112, a window of slots 2-4 of 5 keyframes, the same RenderConfig),
    built from one seed by the port's `build_point` and by the JAX package as
    bench_1m.py builds it: the render's rgb to 1e-5, compact_map's order and
    fields exactly, one mapping_step's losses to rtol 1e-5, and the updated
    parameters where |g| > 1e-6, within 2 lr elsewhere (Adam's first step is
    about lr * sign(g)). The point's gradients are 1e-5 to 3e-3 at most (a
    mean over 36,864 pixels of splats a few pixels wide), so the threshold
    sits below tests/test_torch_mapping.py's 1e-4 and compares more slots."""
    from gslam_tpu.mapping.backend_ops import MapConfig, init_pose_adam, mapping_step
    from gslam_tpu.mapping.gaussians import compact_map, empty_map
    from gslam_tpu.mapping.keyframes import add_keyframe, empty_keyframes
    from gslam_tpu.mapping.optimizer import init_adam
    from gslam_tpu.ops.rasterize import RenderConfig, render
    from gslam_tpu_torch.mapping import gaussians as tg
    from gslam_tpu_torch.mapping import optimizer as to
    from gslam_tpu_torch.mapping.backend_ops import mapping_step as t_mapping_step
    from gslam_tpu_torch.mapping.backend_ops import window_grads

    w, h, fx, cap, n_live, n_kf, window = 128, 96, 112.0, 4096, 3000, 5, 3
    fields, images = bench_1m_torch.point_arrays(cap, n_live, w, h, fx, n_kf)
    point = bench_1m_torch.build_point(fields, images, w, h, fx, window=window, device=CPU)
    gmap, opt, kf, pose_opt, widx, wmask, K, cfg = point
    assert int(gmap.n_live()) == n_live and cfg.render.pairs_per_gaussian == 4

    jK = jnp.asarray(bench_1m_torch.intrinsics(w, h, fx))
    jmap = empty_map(cap)._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    rcfg = RenderConfig(tile_capacity=256, tile_chunk=60, pairs_per_gaussian=4)
    jcfg = MapConfig(window_size=window, render=rcfg)
    jkf = empty_keyframes(16, h, w)
    for slot, img in enumerate(images):
        jkf = add_keyframe(jkf, slot, jnp.asarray(img), jnp.eye(4).at[0, 3].add(0.02 * slot),
                           jnp.zeros(2), slot)
    np.testing.assert_allclose(kf.pose_base.numpy(), np.asarray(jkf.pose_base), atol=1e-7)

    # the single-view render
    jout = render(**jmap.render_kwargs(), viewmats=jnp.eye(4)[None], Ks=jK[None], width=w,
                  height=h, cfg=rcfg)
    tout = bench_1m_torch.render_view(gmap, K, w, h, cfg)
    np.testing.assert_allclose(tout.rgb.numpy(), np.asarray(jout.rgb), atol=1e-5)
    np.testing.assert_array_equal(tout.n_pairs.numpy(), np.asarray(jout.n_pairs))

    # compact_map on the point's map (live slots already first) and on the
    # same map with its live slots scattered
    rng = np.random.default_rng(1)
    scattered = dict(fields, alive=rng.permutation(fields["alive"]))
    for d in (fields, scattered):
        jm = empty_map(cap)._replace(**{k: jnp.asarray(v) for k, v in d.items()})
        tm = tg.gaussian_map_from_numpy(d, device=CPU)
        jc, _, jorder = compact_map(jm, init_adam(jm), return_order=True)
        tc, _, torder = tg.compact_map(tm, to.init_adam(tm), return_order=True)
        np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
        for f in tg.FIELDS:
            np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                          err_msg=f)

    # one mapping step over the window
    jwidx = jnp.asarray(widx.numpy().astype(np.int32))
    jg, _, _, _, jaux = mapping_step(jmap, init_adam(jmap), jkf, init_pose_adam(16), jwidx,
                                     jnp.ones(window, bool), jK, w, h, jcfg)
    tg_map, _, _, _, taux = t_mapping_step(gmap, opt, kf, pose_opt, widx, wmask, K, w, h, cfg)
    for f in ("total_loss", "photometric_loss"):
        np.testing.assert_allclose(float(getattr(taux, f)), float(getattr(jaux, f)), rtol=1e-5,
                                   err_msg=f)
    g_map = window_grads(gmap, kf, widx, wmask, K, w, h, cfg).g_map
    for f in tg.TRAINABLE_FIELDS:
        a, b = getattr(tg_map, f).numpy(), np.asarray(getattr(jg, f))
        sure = np.abs(g_map[f].numpy()) > 1e-6
        assert sure.sum() > 1000, f
        np.testing.assert_allclose(a[sure], b[sure], atol=1e-6, rtol=1e-6, err_msg=f)
        assert np.abs(a - b).max() <= 2 * to.DEFAULT_LRS[f] + 1e-6, f


def test_bench_1m_script_runs_on_the_cpu():
    """The script's measurement at a cut size (2,048 slots, 1,500 live,
    64x48, a window of 2 of 4 keyframes, 2 timed steps), through the
    functions main() chains: bench_1m.py's keys, host-clock times, no blend
    launch (plain versions on the CPU), finite losses."""
    fields, images = bench_1m_torch.point_arrays(2048, 1500, 64, 48, 56.0, 4)
    point = bench_1m_torch.build_point(fields, images, 64, 48, 56.0, window=2, device=CPU)
    detail, steps, _ = bench_1m_torch.measure(point, 64, 48, iters=2)
    line = json.loads(json.dumps(bench_1m_torch.result_line(detail, steps, 64, 48)))
    assert line["value"] == detail["mapping_iter_ms"] and "64x48" in line["metric"]
    d = line["detail"]
    for key in ("capacity", "n_live", "render_ms", "compact_ms", "mapping_iter_ms",
                "mapping_passes_per_s"):
        assert key in d, key
    assert (d["capacity"], d["n_live"], d["timer"]) == (2048, 1500, "host_clock")
    assert d["device_mapping_iter_ms"] is None and d["nvidia_smi"] is None
    assert d["blend_launches_per_step"] == {"blend_fwd": 0, "blend_bwd": 0}
    assert d["render_finite"] and np.isfinite(d["photometric_loss"]).all()
    assert sum(not s["warmup"] for s in steps) == 2


# --------------------------------------------- scripts/study_tracking_torch.py


def test_study_oracle_matches_the_jax_script(monkeypatch, capsys):
    """study_tracking.py and its port in oracle mode at a cut size (48x36,
    400 splats, 4 frames, 30 evaluations), both scripts in this process on
    the same dataset (the port's frames and ground-truth map, handed to the
    JAX script in place of its own SyntheticDataset): the same JSON keys,
    settings and evaluations, per-frame errors within 3 mm. Measured gap
    1.45 mm at frame 3 against the jitted JAX tracker (0.32 mm op by op
    under jax.disable_jit, which takes ~300 s on one core): the chain
    compounds each frame's rounding-level pose difference, which the line
    search amplifies (tests/test_torch_track.py). On its own frames (JAX's
    render, within 1e-5 of the port's) the JAX script lands 4.3 mm away at
    frame 1: 30 evaluations leave the pose 3 cm from the truth, where the
    objective is flat."""
    from types import SimpleNamespace

    import gslam_tpu.io.synthetic as jsynthetic
    from gslam_tpu.mapping.gaussians import empty_map

    argv = ["oracle", "--frames", "4", "--width", "48", "--height", "36", "--n-splats",
            "400", "--evals", "30"]
    ours = study_tracking_torch.main(argv + ["--device", CPU])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == ours
    ds = study_tracking_torch.make_dataset(study_tracking_torch.build_parser().parse_args(argv),
                                           torch.device(CPU))
    f = ds.gt_map_fields
    same = SimpleNamespace(
        gt_map=empty_map(f["means"].shape[0])._replace(
            **{k: jnp.asarray(v) for k, v in f.items()}),
        camera=SimpleNamespace(K=jnp.asarray(ds.camera.K.numpy())), poses=ds.poses,
        images=ds.images)
    monkeypatch.setattr(jsynthetic, "SyntheticDataset", lambda **kw: same)
    theirs = json.loads(_run_script(monkeypatch, capsys, j_study_script, argv).splitlines()[-1])
    assert set(ours) == set(theirs)
    for key in ("mode", "motion", "frames", "median_step_m", "evals", "margin", "warmup",
                "prior", "scene", "tag", "tracker", "pyramid", "mean_evals"):
        assert ours[key] == theirs[key], key
    assert len(ours["per_frame_err_m"]) == 3
    np.testing.assert_allclose(ours["per_frame_err_m"], theirs["per_frame_err_m"], atol=3e-3)
    np.testing.assert_allclose(ours["max_err_m"], theirs["max_err_m"], atol=3e-3)


# ----------------------------------------- scripts/make_npz_dataset_torch.py


@pytest.mark.parametrize("scene", ["synthetic", "raytrace"])
def test_make_npz_dataset_matches_the_jax_script(scene, tmp_path, monkeypatch, capsys):
    """Both scripts at 4 frames of 48x36 (the raytraced room with every
    nuisance): the arrays agree (poses, K and timestamps exactly for the
    synthetic walk; images 1e-5 and depths 2e-5 as each package renders or
    raytraces them, raytraced poses 1e-5), and each package's NpzDataset
    reads the other's file."""
    from gslam_tpu.io.npz import NpzDataset as JNpzDataset
    from gslam_tpu_torch.io.npz import NpzDataset

    argv = ["--scene", scene, "--seq-len", "4", "--width", "48", "--height", "36",
            "--n-splats", "300", "--motion", "0.03", "--seed", "1"]
    if scene == "raytrace":
        argv += ["--noise-std", "0.01", "--exposure-drift", "0.02", "--blur-px", "0.6"]
    ours, theirs = tmp_path / "torch.npz", tmp_path / "jax.npz"
    _run_script(monkeypatch, capsys, j_make_npz_script, [str(theirs), *argv])
    make_npz_dataset_torch.main([str(ours), *argv, "--device", CPU])
    assert capsys.readouterr().out.startswith(f"saved {ours}: {scene} 4f 48x36")
    a, b = np.load(ours), np.load(theirs)
    assert set(a.files) == set(b.files)
    exact = ("K", "hw", "has_depth", "timestamps") + (("gt_poses",) if scene == "synthetic"
                                                     else ())
    for k in a.files:
        if k in exact:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            atol = 2e-5 if k == "depths" else 1e-5
            np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0, err_msg=k)
    for path, reader in ((theirs, NpzDataset), (ours, JNpzDataset)):
        frames = list(reader(path))
        assert len(frames) == 4
        src = b if path == theirs else a
        for i, f in enumerate(frames):
            np.testing.assert_array_equal(np.asarray(f.image), src["images"][i])
            np.testing.assert_array_equal(np.asarray(f.gt_pose), src["gt_poses"][i])


# ---------------------------------------------- scripts/fit_spline_torch.py


def test_fit_spline_matches_jax(tmp_path, capsys):
    """The synthetic demo at 20 steps: the port script's losses within rtol
    1e-4 of JAX's fit_spline on the same trajectory (as fit_spline.py builds
    it); then the --tum path on a groundtruth.txt and accelerometer.txt
    written here."""
    from gslam_tpu.core.transforms import so3_exp
    from gslam_tpu.eval.spline import fit_spline, init_spline, seed_from_poses

    ours = fit_spline_torch.main(["--device", CPU, "--steps", "20",
                                  "--out", str(tmp_path / "fit.png")])
    times = jnp.asarray(np.linspace(0, 10, 120, dtype=np.float32))
    pos = jnp.stack([jnp.sin(times), jnp.cos(0.7 * times), 0.1 * times], -1)
    rot = so3_exp(jnp.stack([0.2 * times, 0.1 * jnp.sin(times), jnp.zeros_like(times)], -1))
    sp = seed_from_poses(init_spline(ours["n_cps"], 0.4, 0.0), times, rot, pos)
    _, losses = fit_spline(sp, times, rot, pos, n_steps=20)
    np.testing.assert_allclose(ours["losses"], np.asarray(losses), rtol=1e-4)
    assert (tmp_path / "fit.png").is_file() and ours["losses"][-1] < ours["losses"][0]

    # --tum: a 5 s walk sampled at 30 Hz, quaternions xyzw, and a 100 Hz accelerometer
    rng = np.random.default_rng(3)
    t = 1000.0 + np.arange(150) / 30.0
    q = rng.normal(scale=0.05, size=(150, 4)) + [0, 0, 0, 1]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    gt = np.column_stack([t, 0.2 * np.sin(t - t[0]), 0.1 * (t - t[0]), np.zeros(150), q])
    np.savetxt(tmp_path / "groundtruth.txt", gt, header="timestamp tx ty tz qx qy qz qw")
    ta = 1000.0 + np.arange(500) / 100.0
    np.savetxt(tmp_path / "accelerometer.txt",
               np.column_stack([ta, rng.normal(scale=0.1, size=(500, 3))]),
               header="timestamp ax ay az")
    capsys.readouterr()
    tum = fit_spline_torch.main(["--device", CPU, "--tum", str(tmp_path), "--steps", "5",
                                 "--out", str(tmp_path / "tum.png")])
    assert "interpolation error" in capsys.readouterr().out
    assert tum["n_cps"] == int((t[-1] - t[0]) / 0.4) + 4
    assert np.isfinite(tum["losses"]).all() and np.isfinite(tum["err"]).all()


# --------------------------------------------------------- teleop_torch.py


def test_teleop_matches_the_jax_tool(tmp_path):
    """Packets (with their CRC-8) equal teleop.py's over a grid of (v, w),
    the EMA sequences equal, and open_sink falls back to a file."""
    for v in np.linspace(-0.5, 0.5, 11):
        for w in np.linspace(-1.2, 1.2, 13):
            assert teleop_torch.make_packet(v, w) == teleop.make_packet(v, w), (v, w)
    ours, theirs = teleop_torch.CommandSmoother(), teleop.CommandSmoother()
    for key in "wwwaadds  sw":
        target = teleop_torch.KEY_VELOCITIES[key]
        assert ours.update(*target) == theirs.update(*target)
    assert teleop_torch.KEY_VELOCITIES == teleop.KEY_VELOCITIES
    sink = teleop_torch.open_sink(str(tmp_path / "teleop.bin"), 115200)
    try:
        sink.write(teleop_torch.make_packet(0.2, -0.8))
    finally:
        sink.close()
    data = (tmp_path / "teleop.bin").read_bytes()
    assert len(data) == 10 and data == teleop.make_packet(0.2, -0.8)


# ---------------------------------------------- scripts/repro_f16_torch.py


def test_repro_objective_matches_jax():
    """repro_f16_torch.objective on a small map against the same composition
    of the JAX package's render and losses (repro_f16.py's `objective`),
    at two poses: each term within rtol 1e-5."""
    from gslam_tpu.ops.losses import apply_exposure, masked_depth_l1, tracking_photometric
    from gslam_tpu.ops.rasterize import RenderConfig as JRenderConfig
    from gslam_tpu.ops.rasterize import render
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.tracking.track import TrackingConfig

    rng = np.random.default_rng(9)
    w, h, n, fx = 48, 36, 300, 40.0
    z = rng.uniform(1.5, 3.0, n).astype(np.float32)
    u, v = rng.uniform(0, w, n), rng.uniform(0, h, n)
    d = dict(means=np.stack([(u - w / 2) * z / fx, (v - h / 2) * z / fx, z], -1)
             .astype(np.float32),
             quats=rng.normal(size=(n, 4)).astype(np.float32),
             log_scales=np.log(rng.uniform(0.03, 0.08, (n, 3))).astype(np.float32),
             logit_opacities=rng.uniform(0.0, 3.0, n).astype(np.float32),
             logit_colors=rng.normal(size=(n, 3)).astype(np.float32),
             log_uncertainties=rng.uniform(-0.3, 0.3, n).astype(np.float32),
             alive=np.ones(n, bool))
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    img = rng.random((h, w, 3)).astype(np.float32)
    dep = rng.uniform(1.5, 3.0, (h, w)).astype(np.float32)
    dep[::4] = 0.0  # pixels without sensor depth
    exposure = np.array([0.05, -0.02], np.float32)
    rcfg, tcfg, _ = repro_f16_torch.configs()
    tcfg = TrackingConfig(use_gt_depths=True, render=rcfg)
    jrcfg = JRenderConfig(tile_capacity=128, tile_chunk=8)
    jmap = {k: jnp.asarray(v) for k, v in d.items()}
    tmap = gaussian_map_from_numpy(d, device=CPU)
    for pose in (np.eye(4, dtype=np.float32),
                 np.array([[1, 0, 0, 0.03], [0, 1, 0, -0.02], [0, 0, 1, 0.05], [0, 0, 0, 1]],
                          np.float32)):
        ours = repro_f16_torch.objective(tmap, torch.from_numpy(pose), torch.from_numpy(img),
                                         torch.from_numpy(dep), torch.from_numpy(exposure),
                                         torch.from_numpy(K), w, h, rcfg, tcfg)
        out = render(**jmap, viewmats=jnp.asarray(pose)[None], Ks=jnp.asarray(K)[None],
                     width=w, height=h, cfg=jrcfg)
        rgb = apply_exposure(out.rgb[0], jnp.asarray(exposure))
        photo = tracking_photometric(rgb, jnp.asarray(img), out.beta[0])
        d_hat = out.depth[0] / jnp.maximum(out.alpha[0], 1e-3)
        dterm = masked_depth_l1(d_hat[None], jnp.asarray(dep)[None], alpha=out.alpha[0][None],
                                alpha_min=tcfg.depth_alpha_min)
        theirs = (float(photo), float(dterm), float(photo + tcfg.depth_loss_weight * dterm),
                  float(jnp.mean(out.alpha[0])))
        assert theirs[1] > 0 and theirs[3] > 0.3
        np.testing.assert_allclose(ours, theirs, rtol=1e-5)


# ------------------------------------------ scripts/decode_run.py on main_torch runs


def test_decode_run_reads_main_torch_runs(tmp_path, monkeypatch, capsys):
    """main_torch on an npz of 3 raytraced 64x48 frames, fused and actor.
    decode_run.py reads the fused run directory: one row per frame (the
    threshold is inf at frame 0, which has no keyframe-decision depth) and
    the metrics line. The actor runtime writes no telemetry.npz (neither does
    the JAX package's; main.py writes it for --fused only), so decode_run
    stops there; the actor's trajectory.npy is the [N, 4, 4] decode_run
    indexes (the JAX actor's [N, 3] file, C-ref2, is not)."""
    monkeypatch.chdir(tmp_path)
    npz = tmp_path / "scene.npz"
    make_npz_dataset_torch.main([str(npz), "--scene", "raytrace", "--seq-len", "3",
                                 "--width", "64", "--height", "48", "--motion", "0.02",
                                 "--seed", "1", "--device", CPU])
    small = ["--device", CPU, "--dataset", "npz", "--scene", str(npz), "--seq-len", "3",
             "--use-gt-depths", "--capacity", "2048", "--kf-capacity", "8",
             "--init-iters", "20", "--mapping-iters", "3", "--eval-stride", "2",
             "--set", "tracking.method=gn", "--set", "tracking.pyramid_levels=2",
             "--set", "tracking.gn_iters=4", "--set", "mapping.window_size=3",
             "--set", "mapping.recent_window=3"]
    main_torch.main(small + ["--fused", "--chunk", "1", "--sync-every", "2",
                             "--init-n-new", "400", "--kf-n-new", "50", "--run-name", "fused"])
    main_torch.main(small + ["--run-name", "actor"])

    out = _run_script(monkeypatch, capsys, decode_run, [str(tmp_path / "runs/fused")])
    lines = out.strip().splitlines()
    rows = [ln for ln in lines[1:] if ln.strip() and not ln.startswith("ate=")]
    assert lines[0].split() == ["f", "err_cm", "gt_step", "kd_trans", "thresh", "cos_z",
                                "kf", "loss", "evals"]
    values = np.array([[float(x) for x in r.split()] for r in rows])
    assert values[:, 0].tolist() == [0, 1, 2] and not np.isnan(values).any()
    assert np.isfinite(np.delete(values, 4, axis=1)).all() and np.isfinite(values[1:]).all()
    assert lines[-1].startswith("ate=") and "psnr=" in lines[-1]

    actor = tmp_path / "runs/actor"
    traj = np.load(actor / "trajectory.npy")
    assert traj.shape == (3, 4, 4) and np.isfinite(traj[:, :3, 3]).all()
    assert not (actor / "telemetry.npz").exists()
    with pytest.raises(FileNotFoundError, match="telemetry.npz"):
        _run_script(monkeypatch, capsys, decode_run, [str(actor)])
