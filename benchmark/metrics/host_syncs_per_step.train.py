"""host_syncs_per_step.train: the program's ``vmt.sync.*`` spans (each a
statement that blocks the host on the card) inside its ``vmt.train.step``
spans, a step, over the traced steps."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None or ctx.window.kind != "train":
        return None
    return spans.syncs_per_call(ctx.trace, spans.STEP)
