"""Frame sources. `build_dataset` is the counterpart of the JAX package's
gslam_tpu/io/__init__.py factory: the same names and keyword arguments; the
loaders that need cv2, PIL or depthai import them when built."""

from gslam_tpu_torch.io.frames import Frame  # noqa: F401
from gslam_tpu_torch.io.replica import ReplicaDataset  # noqa: F401
from gslam_tpu_torch.io.stream import SensorStream  # noqa: F401
from gslam_tpu_torch.io.synthetic import SyntheticDataset  # noqa: F401
from gslam_tpu_torch.io.tum import TumRGBDataset  # noqa: F401


def build_dataset(name: str, scene, seq_len: int = -1, **kw):
    """A dataset by CLI name: 'tum', 'replica', 'synthetic', 'raytrace',
    'npz', 'video' or 'oak'."""
    if name == "tum":
        return TumRGBDataset(scene, seq_len)
    if name == "replica":
        return ReplicaDataset(scene, seq_len)
    if name == "synthetic":
        return SyntheticDataset(seq_len=seq_len if seq_len > 0 else 30, **kw)
    if name == "raytrace":
        from gslam_tpu_torch.io.raytrace import RaytracedDataset

        return RaytracedDataset(seq_len=seq_len if seq_len > 0 else 30, **kw)
    if name == "npz":
        from gslam_tpu_torch.io.npz import NpzDataset

        return NpzDataset(scene, seq_len)
    if name == "video":
        from gslam_tpu_torch.io.video import VideoDataset

        return VideoDataset(scene, **kw)
    if name == "oak":
        from gslam_tpu_torch.io.oakd import OakdSensor

        return OakdSensor(**kw)
    raise ValueError(f"unknown dataset '{name}'")
