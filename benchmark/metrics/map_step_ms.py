"""map_step_ms: the window's seconds over the mapping steps completed in
it, in ms (host clock; the window ends with a synchronize)."""


def read(ctx):
    return 1e3 * ctx.window["window_s"] / ctx.window["units"]
