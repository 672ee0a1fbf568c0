"""ssd_pmixer_roofline: K14's forward (ops.kernels.ssd_pmixer, in_proj
through out_proj of a Mamba-2 layer) at its calls' shapes: least time
(ssd_flops, ssd_pmixer_bytes) over device time, in the traced
window."""

from benchmark import roofline
from benchmark.flops import kernels


def read(ctx):
    dt = roofline.dtype(ctx)
    return roofline.share(ctx, "vmt_ssd_pmixer", lambda cfg: kernels.bound(
        kernels.ssd_pmixer_bytes(cfg, dt), kernels.ssd_flops(cfg, dt))["bound_ms"])
