"""host_syncs_per_call.serve: the program's ``vmt.sync.*`` spans (each a
statement that blocks the host on the card) inside its
``vmt.session.process`` spans, a call, over the traced chunk calls."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None or ctx.window.kind != "stream":
        return None
    return spans.syncs_per_call(ctx.trace, spans.PROCESS)
