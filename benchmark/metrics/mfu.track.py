"""The traced units' share of the card's float32 peak: the operations
their projection and blend passes need (metrics/roofline.py, counted from
the inputs) over the traced wall time."""

from benchmark.metrics import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline.mfu_pct(ctx.work.get("ops", 0.0), ctx.trace["window_s"])
