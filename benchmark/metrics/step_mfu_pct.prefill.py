"""step_mfu_pct.prefill: the hybrid language model's operations in the
window (benchmark.flops.hybrid: every product, the SSD's chunk products,
the attention at each call's cache length, the head) over the window's
seconds, as a share of the card's bf16 peak."""

from benchmark.flops import hybrid, kernels


def read(ctx):
    w = ctx.window
    if w.kind != "stream" or not w.records or "position" not in w.records[0]:
        return None
    flops = sum(hybrid.call_flops(ctx.config, r["batch"], r["chunk_tokens"], r["position"])
                for r in w.records)
    return 100.0 * flops / w.elapsed / kernels.PEAK_FLOPS["bf16"]
