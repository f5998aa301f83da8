"""track_evals_per_frame: TrackResult.n_evals over the window's frames
(loss and gradient evaluations; for Gauss-Newton, render passes)."""


def read(ctx):
    evals = ctx.counters.get("evals")
    return sum(evals) / len(evals) if evals else None
