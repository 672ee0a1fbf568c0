"""process_issue_ms: the median over the traced chunk calls of the
program's ``vmt.session.process`` span less its ``vmt.sync.*`` spans: the
host's own time to issue a call. Near chunk_p50_ms, the call is bound by
the host."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None or ctx.window.kind != "stream":
        return None
    return spans.issue_ms(ctx.trace, spans.PROCESS)
