"""chunk_p95_ms: the 95th percentile of every chunk call's latency in the
window, from handing the host frames over to the features on the host."""

import numpy as np


def read(ctx):
    w = ctx.window
    if w.kind != "stream" or not w.records:
        return None
    return float(np.percentile([(r["end"] - r["start"]) * 1e3 for r in w.records], 95))
