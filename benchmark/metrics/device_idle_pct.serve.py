"""device_idle_pct.serve: the share of the traced window (a whole video of
chunk calls) in which no kernel, memcpy or memset ran on the card."""


def read(ctx):
    if ctx.trace is None or ctx.window.kind != "stream" or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
