"""step_p50_ms: the median time between consecutive training steps'
completions in the window (the first from the window's start; host clock)."""

import numpy as np


def read(ctx):
    w = ctx.window
    if w.kind != "train" or not w.records:
        return None
    ends = [w.t0] + [r["end"] for r in w.records]
    return float(np.median(np.diff(ends))) * 1e3
