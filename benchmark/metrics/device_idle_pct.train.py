"""device_idle_pct.train: the share of the traced window (a few training
steps) in which no kernel, memcpy or memset ran on the card."""


def read(ctx):
    if ctx.trace is None or ctx.window.kind != "train" or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
