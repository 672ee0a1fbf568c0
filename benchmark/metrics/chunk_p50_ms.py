"""chunk_p50_ms: the median chunk call latency in the window (host clock)."""

import numpy as np


def read(ctx):
    w = ctx.window
    if w.kind != "stream" or not w.records:
        return None
    return float(np.percentile([(r["end"] - r["start"]) * 1e3 for r in w.records], 50))
