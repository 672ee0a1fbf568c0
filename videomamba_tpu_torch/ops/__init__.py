"""Numerics ops of the PyTorch port; kernels live in ``ops/kernels``."""

from videomamba_tpu_torch.ops.causal_conv1d import causal_conv1d
from videomamba_tpu_torch.ops.norm import fused_add_norm, layer_norm, rms_norm
from videomamba_tpu_torch.ops.selective_scan import (
    selective_scan_bld,
    selective_scan_ref,
)

__all__ = [
    "causal_conv1d",
    "fused_add_norm",
    "layer_norm",
    "rms_norm",
    "selective_scan_bld",
    "selective_scan_ref",
]
