"""optimizer_host_ms.track: host ms a traced frame spends in the tracker's
optimizer outside its evaluations and linearizations: the self time of the
`track.optimizer` spans (the L-BFGS or Levenberg-Marquardt host loop; for
Gauss-Newton the solves and readbacks are spans of their own) over the
`track.frame` spans."""

from benchmark.metrics import program_trace as pt

NAME = "optimizer_host_ms.track"


def read(ctx):
    s = pt.session(ctx, NAME)
    if s is None:
        return None
    pt.calls(s, "track.optimizer", NAME)
    return pt.self_ms(s, "track.optimizer") / pt.calls(s, "track.frame", NAME)
