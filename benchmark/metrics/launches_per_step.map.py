"""launches_per_step.map: device operations in the traced mapping steps
over the steps."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("units"):
        return None
    return ctx.trace["kernels"] / ctx.work["units"]
