"""block_fused_roofline: K4 (ops.kernels.block_fused, the whole bf16 Block)
at its calls' shapes: least time (block_flops, block_fused_bytes) over
device time, in the traced window."""

from benchmark import roofline
from benchmark.flops import kernels


def read(ctx):
    dt = roofline.dtype(ctx)
    return roofline.share(ctx, "vmt_block_fused", lambda cfg: kernels.bound(
        kernels.block_fused_bytes(cfg, dt), kernels.block_flops(cfg, dt))["bound_ms"])
