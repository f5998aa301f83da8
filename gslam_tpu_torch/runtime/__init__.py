"""The SLAM runtimes: the actor system (system.py) and the fused loop
(fused.py); and trace.py, the recorder the layers below them mark their
spans in. Those layers import trace.py, so the actor system is imported
only when one of its names is first asked for."""

from gslam_tpu_torch.runtime.messages import BackendMessage, FrontendMessage  # noqa: F401


def __getattr__(name):
    if name in ("SlamConfig", "SlamSystem"):
        from gslam_tpu_torch.runtime import system

        return getattr(system, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
