"""attention_roofline: the attention kernel (ops.kernels.attention, each
call in its ``vmt.kernel.attention`` range) at its calls' shapes: the least
time of each call (its QK^T and PV at the bf16 peak, or its Q, K/V and O
bytes at the memory rate, benchmark.flops.hybrid) summed, over the device
time of what the calls launched, in the traced window."""

from benchmark.flops import hybrid, kernels

RANGE = "vmt.kernel.attention"


def read(ctx):
    if ctx.trace is None or ctx.traced is None or not ctx.traced.records:
        return None
    least = device = 0.0
    for ts, dev_s in ctx.trace.entry_calls(RANGE):
        i = ctx.trace.range_index(ctx.traced.range, ts)
        if i is None or i >= len(ctx.traced.records) or dev_s <= 0:
            continue
        r = ctx.traced.records[i]
        args = (ctx.config, r["batch"], r["chunk_tokens"], r["position"])
        least += kernels.bound(hybrid.attention_bytes(*args),
                               {"bf16": hybrid.attention_flops(*args)})["bound_ms"] / 1e3
        device += dev_s
    if device <= 0:
        return None
    return 100.0 * least / device
