"""Telemetry sinks and the viewer."""

from gslam_tpu_torch.viz.visualization import (  # noqa: F401
    NullSink, RerunSink, TelemetrySink, false_colormap, make_sink,
)
