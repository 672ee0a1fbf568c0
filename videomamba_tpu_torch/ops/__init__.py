"""Numerics ops of the PyTorch port; kernels live in ``ops/kernels``."""

from videomamba_tpu_torch.ops.causal_conv1d import causal_conv1d, causal_conv1d_update
from videomamba_tpu_torch.ops.norm import fused_add_norm, layer_norm, rms_norm
from videomamba_tpu_torch.ops.selective_scan import (
    selective_scan_bld,
    selective_scan_ref,
    selective_state_update,
)

__all__ = [
    "causal_conv1d",
    "causal_conv1d_update",
    "fused_add_norm",
    "layer_norm",
    "rms_norm",
    "selective_scan_bld",
    "selective_scan_ref",
    "selective_state_update",
]
