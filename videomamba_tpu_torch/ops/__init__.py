"""Numerics ops of the PyTorch port; kernels live in ``ops/kernels``.

``__all__`` holds every name of the JAX package's ``videomamba_tpu.ops``
(and ``selective_scan_ref``, the port's sequential oracle)."""

from videomamba_tpu_torch.ops.causal_conv1d import causal_conv1d, causal_conv1d_update
from videomamba_tpu_torch.ops.norm import fused_add_norm, layer_norm, rms_norm
from videomamba_tpu_torch.ops.resample import (
    infer_spatial_grid,
    resample_bicubic_2d,
    resample_linear_1d,
)
from videomamba_tpu_torch.ops.selective_scan import (
    selective_scan,
    selective_scan_bld,
    selective_scan_ref,
    selective_state_update,
)

__all__ = [
    "causal_conv1d",
    "causal_conv1d_update",
    "fused_add_norm",
    "infer_spatial_grid",
    "layer_norm",
    "resample_bicubic_2d",
    "resample_linear_1d",
    "rms_norm",
    "selective_scan",
    "selective_scan_bld",
    "selective_scan_ref",
    "selective_state_update",
]
