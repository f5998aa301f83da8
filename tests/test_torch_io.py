"""The port's frame sources against the JAX package's on the CPU: the
raytraced room, the npz cache in both directions, TUM (synchronous and the
timestamp-merged event stream), Replica and video directories written here,
the native loader's crc8, and `build_dataset`'s names.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gslam_tpu.io import build_dataset as j_build_dataset  # noqa: E402
from gslam_tpu.io.npz import NpzDataset as JNpzDataset  # noqa: E402
from gslam_tpu.io.npz import save_dataset_npz as j_save_dataset_npz  # noqa: E402
from gslam_tpu.io.raytrace import RaytracedDataset as JRaytracedDataset  # noqa: E402
from gslam_tpu.io.tum_async import TumAsyncDataset as JTumAsyncDataset  # noqa: E402
from gslam_tpu_torch.io import build_dataset  # noqa: E402
from gslam_tpu_torch.io.frames import Frame  # noqa: E402
from gslam_tpu_torch.io.npz import NpzDataset, save_dataset_npz  # noqa: E402
from gslam_tpu_torch.io.raytrace import RaytracedDataset  # noqa: E402
from gslam_tpu_torch.io.tum_async import DepthSample, IMUSample, TumAsyncDataset  # noqa: E402


def _assert_frames_equal(ours, theirs, atol=0.0):
    """Frame by frame: image, depth, pose, timestamp and index."""
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.index == b.index and a.timestamp == b.timestamp
        np.testing.assert_allclose(a.image, np.asarray(b.image), atol=atol, rtol=0)
        for x, y in ((a.gt_depth, b.gt_depth), (a.gt_pose, b.gt_pose)):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_allclose(x, np.asarray(y), atol=atol, rtol=0)
    np.testing.assert_array_equal(ours[0].camera.K.numpy(), np.asarray(theirs[0].camera.K))
    assert (ours[0].camera.height, ours[0].camera.width) == (
        theirs[0].camera.height, theirs[0].camera.width)


# ------------------------------------------------------------------ raytrace


@pytest.mark.parametrize("nuisances", [False, True], ids=["clean", "nuisances"])
def test_raytraced_frames_match_jax(nuisances):
    kw = dict(seq_len=4, width=48, height=36, motion_scale=0.03, seed=1)
    if nuisances:
        kw.update(noise_std=0.01, exposure_drift=0.02, blur_px=0.6)
    ours, theirs = RaytracedDataset(**kw), JRaytracedDataset(**kw)
    np.testing.assert_allclose(ours.poses, theirs.poses, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours.images, theirs.images, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours.depths, theirs.depths, atol=1e-5, rtol=0)
    _assert_frames_equal(list(ours), list(theirs), atol=1e-5)
    if nuisances:
        np.testing.assert_array_equal(ours.exposure_gt, theirs.exposure_gt)


def test_raytrace_rejects_an_escaping_walk():
    with pytest.raises(ValueError, match="escaped|entered|no surface"):
        RaytracedDataset(seq_len=30, width=16, height=12, motion_scale=0.5, seed=0)


# ----------------------------------------------------------------------- npz


def test_npz_written_by_either_package_reads_in_the_other(tmp_path):
    jds = JRaytracedDataset(seq_len=3, width=32, height=24, seed=2)
    ds = RaytracedDataset(seq_len=3, width=32, height=24, seed=2)
    j_save_dataset_npz(jds, tmp_path / "jax.npz")
    save_dataset_npz(ds, tmp_path / "torch.npz")
    _assert_frames_equal(list(NpzDataset(tmp_path / "jax.npz")), list(jds))
    _assert_frames_equal(list(NpzDataset(tmp_path / "torch.npz")), list(ds))
    _assert_frames_equal(list(NpzDataset(tmp_path / "jax.npz")),
                         list(JNpzDataset(tmp_path / "torch.npz")), atol=1e-5)
    assert len(NpzDataset(tmp_path / "torch.npz", seq_len=2)) == 2


def test_npz_keeps_missing_poses_and_depths(tmp_path):
    """Frames without ground truth round-trip as None."""

    class NoTruth:
        camera = RaytracedDataset(seq_len=1, width=16, height=12).camera
        with_depth = False

        def __iter__(self):
            for i in range(2):
                yield Frame(image=np.full((12, 16, 3), 0.1 * i, np.float32),
                            timestamp=0.5 * i, camera=self.camera, index=i)

    save_dataset_npz(NoTruth(), tmp_path / "x.npz")
    for f in (NpzDataset(tmp_path / "x.npz"), JNpzDataset(tmp_path / "x.npz")):
        frames = list(f)
        assert [fr.gt_pose for fr in frames] == [None, None]
        assert [fr.gt_depth for fr in frames] == [None, None]


# ----------------------------------------------------------------------- TUM


def _write_tum(root, n=3, n_imu=7):
    """A TUM RGB-D directory: 640x480 RGB PNGs, 16-bit depth PNGs (1/5000 m),
    rgb.txt, depth.txt, groundtruth.txt (camera-to-world, xyzw) and an
    accelerometer.txt whose stamps interleave with the frames'."""
    from PIL import Image

    seq = root / "rgbd_dataset_freiburg1_x"
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    rng = np.random.default_rng(5)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i in range(n):
        t = 100.0 + 0.1 * i
        img = (rng.random((480, 640, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(seq / f"rgb/{t:.6f}.png")
        d = rng.integers(2000, 20000, (480, 640)).astype(np.uint16)
        Image.fromarray(d).save(seq / f"depth/{t + 0.01:.6f}.png")
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{t + 0.01:.6f} depth/{t + 0.01:.6f}.png")
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        gt_lines.append(" ".join(f"{v:.6f}" for v in
                                 [t - 0.002, *rng.normal(size=3), *q]))
    (seq / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb_lines) + "\n")
    (seq / "depth.txt").write_text("# depth\n" + "\n".join(depth_lines) + "\n")
    (seq / "groundtruth.txt").write_text("# gt\n" + "\n".join(gt_lines) + "\n")
    acc = [f"{100.0 + 0.05 * k:.6f} {0.1 * k:.3f} 9.81 -0.2" for k in range(n_imu)]
    (seq / "accelerometer.txt").write_text("# accel\n" + "\n".join(acc) + "\n")
    return seq


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    return _write_tum(tmp_path_factory.mktemp("tum"))


def test_tum_frames_match_jax(tum_dir):
    pytest.importorskip("cv2")
    ours = build_dataset("tum", str(tum_dir))
    theirs = j_build_dataset("tum", str(tum_dir))
    assert len(ours) == 3
    _assert_frames_equal(list(ours), list(theirs))
    f = ours[0]
    assert f.image.shape == (ours.camera.height, ours.camera.width, 3)
    assert f.img_file.endswith(".png") and f.gt_depth.max() < 20000 / 5000.0 + 1e-6


def test_tum_async_event_order_matches_jax(tum_dir):
    pytest.importorskip("cv2")
    ours, theirs = TumAsyncDataset(tum_dir), JTumAsyncDataset(tum_dir)
    assert len(ours) == len(theirs) == 3 + 7

    def key(ev):
        return (type(ev).__name__, ev.timestamp, ev.index)

    a, b = list(ours), list(theirs)
    assert [key(e) for e in a] == [key(e) for e in b]
    assert [type(e) for e in a].count(IMUSample) == 7
    assert [type(e) for e in a].count(DepthSample) == 3
    stamps = [e.timestamp for e in a]
    assert stamps == sorted(stamps)
    for x, y in zip(a, b):
        if isinstance(x, IMUSample):
            np.testing.assert_array_equal(x.accel, y.accel)
        elif isinstance(x, DepthSample):
            np.testing.assert_array_equal(x.depth, y.depth)
    assert [f.index for f in ours.frames_only()] == [0, 1, 2]


# ------------------------------------------------------------------- Replica


def test_replica_frames_match_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(6)
    (tmp_path / "results").mkdir()
    c2w = []
    for i in range(2):
        img = (rng.random((120, 200, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / f"results/frame{i:06d}.png")
        d = rng.integers(1000, 30000, (120, 200)).astype(np.uint16)
        Image.fromarray(d).save(tmp_path / f"results/depth{i:06d}.png")
        m = np.eye(4)
        m[:3, 3] = rng.normal(size=3)
        c2w.append(m.reshape(-1))
    np.savetxt(tmp_path / "traj.txt", np.stack(c2w))
    ours = build_dataset("replica", str(tmp_path))
    theirs = j_build_dataset("replica", str(tmp_path))
    _assert_frames_equal(list(ours), list(theirs))
    assert ours[0].gt_depth.shape == ours[0].image.shape[:2]


# --------------------------------------------------------------------- video


def test_video_frames_match_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (64, 48))
    rng = np.random.default_rng(7)
    for _ in range(33):
        w.write((rng.random((48, 64, 3)) * 255).astype(np.uint8))
    w.release()
    ours, theirs = build_dataset("video", path), j_build_dataset("video", path)
    a, b = list(ours), list(theirs)
    assert len(a) == 3  # 33 frames, the first 30 skipped
    for x, y in zip(a, b):
        assert (x.index, x.timestamp) == (y.index, y.timestamp)
        np.testing.assert_array_equal(x.image, y.image)
    np.testing.assert_array_equal(ours.camera.K.numpy(), np.asarray(theirs.camera.K))


# ------------------------------------------------------- native, the factory


def test_native_crc8():
    from gslam_tpu_torch.io.native import crc8

    assert crc8(b"123456789") == 0xF4
    assert crc8(b"") == 0x00


def test_build_dataset_names(tmp_path):
    ds = build_dataset("raytrace", None, 2, width=16, height=12, n_splats=5,
                       motion_scale=0.01, seed=0)
    assert isinstance(ds, RaytracedDataset) and len(ds) == 2
    syn = build_dataset("synthetic", None, 2, width=16, height=16, n_splats=50,
                        motion_scale=0.01, seed=0, device="cpu")
    assert len(syn) == 2 and syn[1].image.shape == (16, 16, 3)
    save_dataset_npz(ds, tmp_path / "d.npz")
    assert len(build_dataset("npz", str(tmp_path / "d.npz"))) == 2
    with pytest.raises(ValueError, match="unknown dataset"):
        build_dataset("kitti", None)
    # OAK-D capture needs the depthai SDK: the same clear error as the JAX package
    with pytest.raises(RuntimeError, match="depthai"):
        build_dataset("oak", None)
