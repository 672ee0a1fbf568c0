"""program_idle_pct.serve: the share of the traced window in which no
kernel, memcpy or memset runs on the card while the host is inside the
program's ``vmt.session.process`` span; the rest of device_idle_pct.serve
falls outside the program's call, in the benchmark's loop."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None or ctx.window.kind != "stream":
        return None
    return spans.idle_pct_inside(ctx.trace, spans.PROCESS)
