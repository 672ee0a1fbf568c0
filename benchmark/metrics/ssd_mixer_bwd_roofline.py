"""ssd_mixer_bwd_roofline: K13 (ops.kernels.ssd_mixer_bwd, the Mamba-2
mixer's backward) at its steps' shapes: least time (ssd_bwd_flops,
ssd_mixer_bwd_bytes) over device time, in the traced window."""

from benchmark import roofline
from benchmark.flops import kernels


def read(ctx):
    dt = roofline.dtype(ctx)
    return roofline.share(ctx, "vmt_ssd_mixer_bwd", lambda cfg: kernels.bound(
        kernels.ssd_mixer_bwd_bytes(cfg, dt), kernels.ssd_bwd_flops(cfg, dt))["bound_ms"])
