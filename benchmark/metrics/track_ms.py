"""track_ms: the window's seconds over the frames tracked in it, in ms
(host clock; the window ends at the last frame's synchronized end)."""


def read(ctx):
    return 1e3 * ctx.window["window_s"] / ctx.window["units"]
