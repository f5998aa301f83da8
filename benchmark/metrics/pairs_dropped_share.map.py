"""pairs_dropped_share.map: of the (splat, tile) pairs binning was asked
for in the traced mapping steps, the share in percent it dropped, over the
pair budget or over a tile's capacity (the program's counters pairs.*)."""

from benchmark.metrics import program_trace as pt

NAME = "pairs_dropped_share.map"


def read(ctx):
    s = pt.session(ctx, NAME)
    return None if s is None else pt.dropped_share(s, NAME)
