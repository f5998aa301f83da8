"""binning_syncs_per_step.map: host syncs inside the traced steps'
`binning` spans, per `map.step` span."""

from benchmark.metrics import program_trace as pt

NAME = "binning_syncs_per_step.map"


def read(ctx):
    s = pt.session(ctx, NAME)
    if s is None:
        return None
    pt.calls(s, "binning", NAME)
    return pt.syncs_under(s, "binning") / pt.calls(s, "map.step", NAME)
