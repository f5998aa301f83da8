"""The SLAM runtimes: the actor system (system.py) and the fused loop
(fused.py)."""

from gslam_tpu_torch.runtime.messages import BackendMessage, FrontendMessage  # noqa: F401
from gslam_tpu_torch.runtime.system import SlamConfig, SlamSystem  # noqa: F401
