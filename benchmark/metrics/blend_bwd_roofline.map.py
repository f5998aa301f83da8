"""The backward blend kernel's share of its roofline in the traced units:
the summed bounds of its calls (metrics/roofline.py, counted from the
benchmark's binning of the inputs) over its device time in the trace."""

from benchmark.metrics import roofline
from benchmark.metrics.trace_summary import kernel_seconds


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline.share_pct(ctx.work.get("blend_bwd"),
                              kernel_seconds(ctx.trace, "blend_bwd_kernel"))
