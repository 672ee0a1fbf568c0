"""step_mfu_pct.train: the training steps' operations in the window (three
forwards each, benchmark.flops.model) over the window's seconds, as a share
of the card's bf16 peak."""

from benchmark.flops import kernels, model


def read(ctx):
    w = ctx.window
    if w.kind != "train" or not w.records:
        return None
    flops = sum(model.train_step_flops(ctx.config, r["batch"] * r["block_tokens"],
                                       r["batch"] * r["patch_tokens"]) for r in w.records)
    return 100.0 * flops / w.elapsed / kernels.PEAK_FLOPS["bf16"]
