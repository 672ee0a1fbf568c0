"""step_mfu_pct.serve: the served model's operations in the window
(benchmark.flops.model: every product's weights and the sequence mix, over
every stream's tokens) over the window's seconds, as a share of the card's
bf16 peak."""

from benchmark.flops import kernels, model


def read(ctx):
    w = ctx.window
    if w.kind != "stream" or not w.records:
        return None
    flops = sum(model.forward_flops(ctx.config, r["batch"] * r["block_tokens"],
                                    r["batch"] * r["patch_tokens"]) for r in w.records)
    return 100.0 * flops / w.elapsed / kernels.PEAK_FLOPS["bf16"]
