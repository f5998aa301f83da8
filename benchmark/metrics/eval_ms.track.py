"""eval_ms.track: host ms of one loss-and-gradient evaluation of the
tracker, the mean over the traced frames' `track.eval` spans (render,
loss, autograd and the readback of the loss, which waits for the device:
the span ends when the evaluation's device work does)."""

from benchmark.metrics import program_trace as pt

NAME = "eval_ms.track"


def read(ctx):
    s = pt.session(ctx, NAME)
    if s is None:
        return None
    return pt.total_ms(s, "track.eval") / pt.calls(s, "track.eval", NAME)
