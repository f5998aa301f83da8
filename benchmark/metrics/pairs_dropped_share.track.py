"""pairs_dropped_share.track: of the (splat, tile) pairs binning was asked
for in the traced frames (binned once a pyramid level, at the prior), the
share in percent it dropped, over the pair budget or over a tile's
capacity (the program's counters pairs.*)."""

from benchmark.metrics import program_trace as pt

NAME = "pairs_dropped_share.track"


def read(ctx):
    s = pt.session(ctx, NAME)
    return None if s is None else pt.dropped_share(s, NAME)
