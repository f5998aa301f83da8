"""track_p95_ms: the 95th percentile of every frame's time in the window,
each from its call to its synchronized end, in ms (host clock)."""

from benchmark.stats import percentile


def read(ctx):
    return 1e3 * percentile(ctx.window["unit_s"], 95.0)
