"""setup_s: seconds from the process's start to the first timed unit
(host clock): loading, making the inputs, building the program's state,
the warm-up and any check steps that set-up runs."""


def read(ctx):
    return ctx.window["setup_s"]
