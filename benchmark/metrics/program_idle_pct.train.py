"""program_idle_pct.train: the share of the traced window in which no
kernel, memcpy or memset runs on the card while the host is inside the
program's ``vmt.train.step`` span; the rest of device_idle_pct.train falls
outside the program's step, in the benchmark's loop."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None or ctx.window.kind != "train":
        return None
    return spans.idle_pct_inside(ctx.trace, spans.STEP)
