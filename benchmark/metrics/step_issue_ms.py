"""step_issue_ms: the median over the traced steps of the program's
``vmt.train.step`` span less its ``vmt.sync.*`` spans: the host's own time
to issue a step. Near step_p50_ms, the step is bound by the host."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None or ctx.window.kind != "train":
        return None
    return spans.issue_ms(ctx.trace, spans.STEP)
