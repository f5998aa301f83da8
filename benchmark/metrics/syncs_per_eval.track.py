"""syncs_per_eval.track: host syncs inside the traced frames' `track.frame`
spans over the evaluations they made (the program's counter
`track.evals`)."""

from benchmark.metrics import program_trace as pt

NAME = "syncs_per_eval.track"


def read(ctx):
    s = pt.session(ctx, NAME)
    if s is None:
        return None
    pt.calls(s, "track.frame", NAME)
    return pt.syncs_under(s, "track.frame") / pt.counter(s, "track.evals", NAME)
