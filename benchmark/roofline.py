"""A kernel's share of its roofline in the traced window.

For each call of the port's C entry inside the traced window, the least
time the card could take for it (``flops.kernels.bound`` of its operations
and bytes at the shapes of the call or step that made it), summed, over
the device time of everything that call launched, summed: the mean least
time per launch over the mean device time per launch. A call or step is
the driver's range (``Window.range``) that holds the entry's call.
"""

from __future__ import annotations

from typing import Callable, Optional

from benchmark.flops import model

def shapes(ctx, rec: dict) -> dict:
    """The operation counts' ``cfg`` for one call or step: its batch and the
    tokens its Blocks run, with the configuration's widths."""
    d = model.mixer_dims(ctx.config)
    return dict(d, batch=rec["batch"], seqlen=rec["block_tokens"])


def dtype(ctx) -> str:
    return "bf16" if ctx.config["dtype"] == "bfloat16" else "fp32"


def share(ctx, entry: str, least_ms: Callable[[dict], float]) -> Optional[float]:
    if ctx.trace is None or ctx.traced is None or not ctx.traced.records:
        return None
    calls = ctx.trace.entry_calls(entry)
    name = ctx.traced.range
    least = device = 0.0
    for ts, dev_s in calls:
        i = ctx.trace.range_index(name, ts)
        if i is None or i >= len(ctx.traced.records) or dev_s <= 0:
            continue
        least += least_ms(shapes(ctx, ctx.traced.records[i])) / 1e3
        device += dev_s
    if device <= 0:
        return None
    return 100.0 * least / device
