"""peak_mem_gib: torch.cuda.max_memory_allocated over the window (reset
after set-up), in GiB."""


def read(ctx):
    if ctx.peak_bytes is None:
        return None
    return ctx.peak_bytes / 2 ** 30
