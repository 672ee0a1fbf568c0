"""mixer_bwd_roofline: K6 (ops.kernels.mixer_bwd, the Mamba-1 mixer core's
backward) at its steps' shapes: least time (mixer_flops backward,
mixer_bwd_bytes) over device time, in the traced window."""

from benchmark import roofline
from benchmark.flops import kernels


def read(ctx):
    dt = roofline.dtype(ctx)

    def least(c):
        flops = kernels.mixer_flops(c["batch"], c["seqlen"], c["d_inner"], c["d_state"],
                                    c["dt_rank"], c["width"], dt, backward=True)
        return kernels.bound(kernels.mixer_bwd_bytes(c, dt), flops)["bound_ms"]

    return roofline.share(ctx, "vmt_mixer_bwd", least)
