"""binning_ms.map: device ms a traced mapping step spends in tile binning,
per step: the device side of the `binning` range (from its first kernel's
start to its last kernel's end), which the benchmark wraps around the
program's calls into binning and the program may mark itself. A traced
run on the card without that range is an error, not a silent metric: the
range is gone where binning is reached another way."""


def read(ctx):
    if ctx.trace is None:
        return None
    seconds = ctx.trace["device_range_s"].get("binning")
    if not seconds:
        raise RuntimeError("binning_ms.map: the traced steps hold no device-side 'binning' "
                           "range; binning is no longer reached through the wrapped call")
    return 1e3 * seconds / ctx.work["units"]
