"""linearize_ms.track: host ms of one Gauss-Newton linearization, the mean
over the traced frames' `track.linearize` spans (the primal and tangent
passes of torch.func.jvp under vmap, JtJ and Jtr)."""

from benchmark.metrics import program_trace as pt

NAME = "linearize_ms.track"


def read(ctx):
    s = pt.session(ctx, NAME)
    if s is None:
        return None
    return pt.total_ms(s, "track.linearize") / pt.calls(s, "track.linearize", NAME)
