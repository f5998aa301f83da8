"""The renderer: projection, binning, the blend kernels and the losses.
Importing it builds no kernel: ops/cuda_build.py compiles csrc/ inside the
first call that launches one."""

from gslam_tpu_torch.ops.projection import ProjectionOutput, project_gaussians  # noqa: F401
from gslam_tpu_torch.ops.rasterize import RenderConfig, RenderOutput, render  # noqa: F401
