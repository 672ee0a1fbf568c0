"""setup_s: seconds from the process's start to the first timed call:
imports, the card's context, the kernel library (built on a first run in a
checkout), the model and its weights, the inputs, and the warm-up."""


def read(ctx):
    return ctx.setup_s
