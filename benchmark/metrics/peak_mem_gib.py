"""peak_mem_gib: torch.cuda.max_memory_allocated over the program's
set-up and the window, in GiB; nothing off the card."""


def read(ctx):
    peak = ctx.window["peak_bytes"]
    return None if peak is None else peak / 2**30
