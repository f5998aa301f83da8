"""The PyTorch port stands alone: no module of gslam_tpu_torch, and not
chip_smoke.py or the port's entry scripts and tools, imports JAX or the JAX
package; and an entry point given no device on a host without CUDA raises
instead of running on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# the package, the port's entry scripts and its tools
TOOLS = ("scripts/bench_1m_torch.py", "scripts/study_tracking_torch.py",
         "scripts/repro_f16_torch.py", "scripts/demo_track_torch.py",
         "scripts/make_npz_dataset_torch.py", "scripts/fit_spline_torch.py", "teleop_torch.py")
SOURCES = sorted((ROOT / "gslam_tpu_torch").rglob("*.py")) + [
    ROOT / name for name in ("chip_smoke.py", "profile_torch_track.py", "bench_blend.py",
                             "bench_torch.py", "main_torch.py", "pipeline_torch.py",
                             "view_torch.py", *TOOLS)]
FORBIDDEN = ("jax", "jaxlib", "gslam_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_sources_found():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {"chip_smoke.py", "profile_torch_track.py", "bench_blend.py", "bench_torch.py",
            "gslam_tpu_torch/ops/blend.py", "gslam_tpu_torch/tracking/track.py",
            "gslam_tpu_torch/mapping/backend_ops.py", "gslam_tpu_torch/ops/ssim.py",
            "gslam_tpu_torch/runtime/fused.py", "gslam_tpu_torch/runtime/checkpoint.py",
            "gslam_tpu_torch/mapping/insertion.py", "gslam_tpu_torch/ops/knn.py",
            "gslam_tpu_torch/core/camera.py", "gslam_tpu_torch/io/frames.py",
            "gslam_tpu_torch/io/synthetic.py", "gslam_tpu_torch/eval/trajectory.py",
            "gslam_tpu_torch/opt/lbfgs.py", "gslam_tpu_torch/tracking/warp.py",
            "gslam_tpu_torch/runtime/messages.py", "gslam_tpu_torch/runtime/frontend.py",
            "gslam_tpu_torch/runtime/backend.py", "gslam_tpu_torch/runtime/system.py",
            "gslam_tpu_torch/runtime/trace.py",
            "gslam_tpu_torch/eval/metrics.py", "gslam_tpu_torch/viz/visualization.py",
            "gslam_tpu_torch/io/stream.py", "main_torch.py", "pipeline_torch.py",
            "view_torch.py", "gslam_tpu_torch/io/__init__.py", "gslam_tpu_torch/io/raytrace.py",
            "gslam_tpu_torch/io/npz.py", "gslam_tpu_torch/io/native.py",
            "gslam_tpu_torch/io/tum.py", "gslam_tpu_torch/io/tum_async.py",
            "gslam_tpu_torch/io/replica.py", "gslam_tpu_torch/io/video.py",
            "gslam_tpu_torch/io/oakd.py", "gslam_tpu_torch/eval/spline.py",
            "gslam_tpu_torch/viz/viewer.py", "gslam_tpu_torch/parallel/__init__.py",
            "gslam_tpu_torch/parallel/sharding.py", "gslam_tpu_torch/parallel/slam.py",
            *TOOLS} <= names


def test_entry_points_refuse_cpu_without_a_device(monkeypatch):
    from gslam_tpu_torch import resolve_device
    from gslam_tpu_torch.mapping.backend_ops import init_pose_adam
    from gslam_tpu_torch.mapping.gaussians import empty_map, gaussian_map_from_numpy
    from gslam_tpu_torch.mapping.keyframes import empty_keyframes
    from gslam_tpu_torch.runtime.fused import FusedConfig, FusedSlam, init_fused_state
    from gslam_tpu_torch.runtime.system import SlamConfig, SlamSystem
    from gslam_tpu_torch.tracking.track import track_frame

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        empty_map(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        gaussian_map_from_numpy({"means": np.zeros((2, 3))})
    with pytest.raises(RuntimeError, match="CUDA"):
        empty_keyframes(2, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_pose_adam(2)
    gmap = empty_map(4, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        track_frame(gmap, np.eye(4), np.zeros(2), np.zeros((16, 16, 3)),
                    np.eye(3), 16, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_fused_state(FusedConfig(max_frames=2), 4, 2, 16, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedSlam(FusedConfig(max_frames=2), 16, 16, capacity=4, kf_capacity=2).run([])
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamSystem(SlamConfig(capacity=4, kf_capacity=2), 16, 16)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_refuses_cpu_without_a_device(monkeypatch, tmp_path):
    """main_torch, pipeline_torch and view_torch without --device on a host
    without CUDA raise before they build anything."""
    import main_torch
    import pipeline_torch
    import view_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        main_torch.main(["--dataset", "synthetic", "--seq-len", "2", "--width", "16",
                         "--height", "16", "--n-splats", "10", "--run-name", "x"])
    assert not (tmp_path / "runs").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline_torch.main(["--synthetic", "--iters", "1", "--out", str(tmp_path / "p")])
    with pytest.raises(RuntimeError, match="CUDA"):
        view_torch.main([str(tmp_path / "missing.npz")])


def test_tools_refuse_cpu_without_a_device(monkeypatch, tmp_path):
    """Each ported tool that computes with torch, and bench_torch.py (whole
    and one section), given no --device on a host without CUDA, raises before
    it builds or writes anything."""
    import bench_torch

    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import bench_1m_torch
        import demo_track_torch
        import fit_spline_torch
        import make_npz_dataset_torch
        import repro_f16_torch
        import study_tracking_torch
    finally:
        sys.path.remove(str(ROOT / "scripts"))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    calls = [
        (bench_torch, []),
        (bench_torch, ["--section", "mapping"]),
        (bench_1m_torch, []),
        (study_tracking_torch, ["oracle", "--frames", "2", "--width", "16", "--height", "16",
                                "--n-splats", "10"]),
        (study_tracking_torch, ["mono", "--scene", "raytrace", "--frames", "2"]),
        (repro_f16_torch, []),
        (demo_track_torch, [str(tmp_path / "demo")]),
        (make_npz_dataset_torch, [str(tmp_path / "x.npz"), "--scene", "raytrace",
                                  "--seq-len", "2", "--width", "16", "--height", "16"]),
        (fit_spline_torch, ["--steps", "1", "--out", str(tmp_path / "fit.png")]),
    ]
    for module, argv in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            module.main(argv)
    assert not any(tmp_path.iterdir())


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA here: the smoke run must exit non-zero and print no result,
    from the checkout and from a directory holding only the script."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        if torch.cuda.is_available() and script.parent == ROOT:
            continue
        proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                              text=True, timeout=300, cwd=script.parent)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
