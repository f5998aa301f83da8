"""The device's idle share of the traced wall time, in percent: 1 - busy
/ wall, busy the union of device operations. The profiler's host overhead
lengthens the traced wall, so this is an upper bound on the unprofiled
idle share."""


def read(ctx):
    if ctx.trace is None or ctx.trace["idle_share"] is None:
        return None
    return 100.0 * ctx.trace["idle_share"]
