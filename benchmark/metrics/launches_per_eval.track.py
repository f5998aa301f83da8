"""launches_per_eval.track: device operations in the traced frames over
the evaluations they made."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("evals"):
        return None
    return ctx.trace["kernels"] / ctx.work["evals"]
